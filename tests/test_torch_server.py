"""The port's REST and WebSocket server against the JAX package's, through
aiohttp's test client on the CPU.

Both servers serve their package's `build_model()` on the CPU (the shipped
checkpoints, float32) with one small random separator in place of the
256/12 one (`test_torch_stream_systems.py`). The inputs are synthesized
two-voice WAV bytes made from numpy seeds. The responses must have the
same schema and values: speakers, speaker types, types and scores equal,
timeranges within 10 ms, statistics within 0.02 s, the same texts except
where a clip was separated (one character in 33, as in
`test_torch_offline.py`: the streams agree within 1 LSB of int16, which can
flip an argmax of the bootstrap Paraformer), and the same WS message
sequence. Timings (`processing_time`, the latency percentiles) are
compared by presence only.
"""

import asyncio
import base64
import io
import os
import wave

import jax
import numpy as np
import pytest
import torch
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

from chip_smoke import cer, dialogue, enrollment, strip_punct
from targetdiarization_tpu.runtime.config import env_config as jax_env_config
from targetdiarization_tpu.serve import server as jserver
from targetdiarization_tpu_torch.serve import server as tserver
from test_torch_stream_systems import stream_systems

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return stream_systems()


def wav_bytes(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.clip(np.round(audio * 32767), -32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def on_both(models, steps):
    """`steps(client)` against the port's app, then the JAX package's."""

    async def run(module, model):
        async with TestClient(TestServer(module.create_app(model))) as client:
            return await steps(client)

    ours, theirs = models
    got = asyncio.run(run(tserver, ours))
    with jax.default_matmul_precision("highest"):
        want = asyncio.run(run(jserver, theirs))
    return got, want


def same_segments(got: list, want: list, separated: bool, keys=("speaker", "speaker_type",
                                                                 "type", "score")):
    assert len(got) == len(want) > 0, (got, want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert all(g[k] == w[k] for k in keys if k in w), (g, w)
        assert max(abs(a - b) for a, b in zip(g["timerange"], w["timerange"])) <= 0.01
        if not separated:
            assert g["text"] == w["text"]
    text_g = "".join(strip_punct(s["text"]) for s in got)
    text_w = "".join(strip_punct(s["text"]) for s in want)
    assert round(cer(text_w, text_g) * len(text_w)) <= max(1, 0.03 * len(text_w))


def test_root_and_health_match_jax(models):
    async def steps(client):
        root = await (await client.get("/")).json()
        health = await (await client.get("/health")).json()
        return root, health

    (root, health), (want_root, want_health) = on_both(models, steps)
    assert root == want_root and root["endpoints"]["streaming"] == "/diarization/stream"
    assert set(health) == set(want_health) and health["model_loaded"] is True
    assert health["status"] == want_health["status"] == "healthy"


def test_rest_infer_matches_jax(models):
    audio, target = dialogue(3.0, seed=31, overlap=True), enrollment(4.0, seed=9)

    async def steps(client):
        form = FormData()
        form.add_field("audio_file", wav_bytes(audio), filename="mix.wav",
                       content_type="audio/wav")
        form.add_field("target_file", wav_bytes(target), filename="target.wav",
                       content_type="audio/wav")
        r = await client.post("/diarization/infer", data=form)
        return r.status, await r.json()

    (status, got), (want_status, want) = on_both(models, steps)
    assert status == want_status == 200
    assert got["success"] is want["success"] is True, (got, want)
    assert set(got) == set(want) and got["processing_time"] > 0
    g, w = got["data"], want["data"]
    assert set(g) == set(w) and "target_audio_base64" in w
    assert (g["target_speaker_id"], g["total_speakers"]) == \
        (w["target_speaker_id"], w["total_speakers"])
    separated = any(s["type"] == "overlap" for s in w["results"])
    same_segments(g["results"], w["results"], separated)
    for k, v in w["statistics"].items():
        assert abs(g["statistics"][k] - v) <= 0.02, (g["statistics"], w["statistics"])
    assert len(g["target_audio_base64"]) == len(w["target_audio_base64"])


def test_rest_infer_single_speaker_mode_matches_jax(models):
    audio = dialogue(3.0, seed=32, overlap=False)

    async def steps(client):
        form = FormData()
        form.add_field("audio_file", wav_bytes(audio), filename="mix.wav",
                       content_type="audio/wav")
        r = await client.post("/diarization/infer?is_single=true&output_target_audio=false",
                              data=form)
        return await r.json()

    got, want = on_both(models, steps)
    assert got["success"] is want["success"] is True
    assert "target_audio_base64" not in got["data"] and "target_audio_base64" not in want["data"]
    same_segments(got["data"]["results"], want["data"]["results"], separated=False)


def test_rest_infer_missing_audio(models):
    async def steps(client):
        r = await client.post("/diarization/infer", data=FormData())
        return r.status, await r.json()

    got, want = on_both(models, steps)
    assert got == want and got[0] == 422


def _ws_steps(audio, target):
    async def steps(client):
        ws = await client.ws_connect("/diarization/stream")
        await ws.send_json({"type": "config", "data": {"sampling_rate": SR,
                                                       "has_target_file": True}})
        await ws.send_json({"type": "target_audio",
                            "data": tserver.audio_to_base64(target)})
        ack = await ws.receive_json()
        for i in range(0, len(audio), SR):
            pcm = np.round(audio[i: i + SR] * 32767).astype(np.int16).tobytes()
            await ws.send_json({"type": "audio_chunk", "data": base64.b64encode(pcm).decode()})
        await ws.send_json({"type": "audio_end"})
        messages = []
        while True:
            msg = await asyncio.wait_for(ws.receive_json(), timeout=600)
            messages.append(msg)
            if msg["type"] in ("status", "error"):
                break
        await ws.close()
        return ack, messages
    return steps


def test_ws_stream_matches_jax(models):
    audio, target = dialogue(4.0, seed=1, overlap=True), enrollment(8.0, seed=9)
    (ack, got), (want_ack, want) = on_both(models, _ws_steps(audio, target))
    assert ack == want_ack and ack["type"] == "config_ack"
    assert ack["data"]["target_file_loaded"] is True
    assert got[-1]["type"] == want[-1]["type"] == "status"
    assert got[-1]["message"] == "completed"
    assert set(got[-1]["metrics"]) == set(want[-1]["metrics"])
    assert {"intake_p50_ms", "emission_p50_ms"} <= set(got[-1]["metrics"])
    segs = [m["data"]["segment"] for m in got[:-1]]
    want_segs = [m["data"]["segment"] for m in want[:-1]]
    assert all(m["type"] == "segment_result" for m in got[:-1] + want[:-1])
    assert [m["data"]["target_speaker_id"] for m in got[:-1]] == \
        [m["data"]["target_speaker_id"] for m in want[:-1]]
    same_segments(segs, want_segs, separated=False, keys=("speaker", "speaker_type", "type"))


def test_ws_concurrent_sessions(models):
    """Two WS clients at once, each with its own session state."""

    async def steps(client):
        async def one(seed):
            ws = await client.ws_connect("/diarization/stream")
            await ws.send_json({"type": "config", "data": {}})
            assert (await ws.receive_json())["type"] == "config_ack"
            pcm = np.round(dialogue(2.0, seed=seed, overlap=False) * 32767).astype(np.int16)
            for i in range(0, len(pcm), SR):
                await ws.send_json({"type": "audio_chunk",
                                    "data": base64.b64encode(pcm[i: i + SR].tobytes()).decode()})
            await ws.send_json({"type": "audio_end"})
            while True:
                msg = await asyncio.wait_for(ws.receive_json(), timeout=600)
                if msg["type"] in ("status", "error"):
                    break
            await ws.close()
            return msg["type"]

        return await asyncio.gather(one(41), one(42))

    async def run():
        async with TestClient(TestServer(tserver.create_app(models[0]))) as client:
            return await steps(client)

    assert asyncio.run(run()) == ["status", "status"]


def test_ws_without_model_reports_an_error():
    async def run():
        async with TestClient(TestServer(tserver.create_app(None))) as client:
            ws = await client.ws_connect("/diarization/stream")
            msg = await ws.receive_json()
            await ws.close()
            r = await client.post("/diarization/infer", data=FormData())
            return msg, r.status, await r.json()

    msg, status, body = asyncio.run(run())
    assert msg == {"type": "error", "message": "Model not loaded"}
    assert status == 500 and body == {"success": False, "error": "Model not loaded"}


def test_web_ui_served():
    async def run():
        async with TestClient(TestServer(tserver.create_app(None))) as client:
            r = await client.get("/target-diarization")
            return r.status, await r.text()

    status, text = asyncio.run(run())
    assert status == 200 and "Target Diarization" in text and "diarization/stream" in text


def test_base64_round_trip_matches_jax():
    x = np.linspace(-0.9, 0.9, 1001).astype(np.float32)
    enc = tserver.audio_to_base64(x)
    assert enc == jserver.audio_to_base64(x)
    np.testing.assert_array_equal(tserver.base64_to_audio(enc), jserver.base64_to_audio(enc))
    assert tserver.audio_to_base64(None) == ""
    assert [tserver.format_speaker_info(s, "1") for s in ("1", "-1", "0")] == \
        ["target", "uncertain", "other"]


def test_checkpoint_names_match_jax(tmp_path, monkeypatch):
    repo = str(tmp_path)
    for v in ("whisper-v2", "whisper-v3", "whisper-finetune", "sep-bootstrap-512"):
        os.makedirs(os.path.join(repo, "checkpoints", v))
    for eng in ("whisper_v2", "whisper_v3", "whisper_finetune", "whisper", "sensevoice",
                "paraformer"):
        assert tserver._asr_checkpoint_name(repo, eng) == jserver._asr_checkpoint_name(repo, eng)
    assert tserver._asr_checkpoint_name(str(tmp_path / "nope"), "whisper_v2") == \
        "whisper-bootstrap"
    monkeypatch.delenv("TD_SEP_CHECKPOINT", raising=False)
    assert tserver._separator_checkpoint_name(repo, "cuda") == "sep-bootstrap-512"
    assert tserver._separator_checkpoint_name(repo, "cpu") == "sep-bootstrap"
    assert tserver._separator_checkpoint_name(str(tmp_path / "nope"), "cuda") == "sep-bootstrap"
    monkeypatch.setenv("TD_SEP_CHECKPOINT", "sep-other")
    assert tserver._separator_checkpoint_name(repo, "cuda") == "sep-other"


def test_build_model_on_the_cpu_takes_the_256_separator(models):
    ours, theirs = models
    built = tserver.build_model(device="cpu")
    assert len(built.ap.separator.model.mask_net.layers) == 12
    assert built.ap.separator.device.type == "cpu"
    assert built.ap.separator.compute_dtype == torch.float32
    assert ours.tasr.asrp.asr is not None and ours.od_pipeline is not None
    assert type(ours).__name__ == type(theirs).__name__ == "TargetDiarizationStream"
    assert (ours.max_buffer_duration, ours.similarity_threshold, ours.vad_min_silence) == \
        (theirs.max_buffer_duration, theirs.similarity_threshold, theirs.vad_min_silence)


def test_create_app_needs_aiohttp(monkeypatch):
    monkeypatch.setattr(tserver, "HAS_AIOHTTP", False)
    with pytest.raises(RuntimeError, match="aiohttp"):
        tserver.create_app(None)


def test_config_matches_jax(monkeypatch, tmp_path):
    from targetdiarization_tpu_torch.runtime.config import env_config

    env = tmp_path / ".env"
    env.write_text("MAX_BUFFER_DURATION=12.5\n# a comment\nIS_VAD_BUFFER='false'\n")
    monkeypatch.setenv("QUALITY", "3")
    monkeypatch.delenv("MAX_BUFFER_DURATION", raising=False)
    monkeypatch.delenv("IS_VAD_BUFFER", raising=False)
    ours, theirs = env_config(str(env)), jax_env_config(str(env))
    assert (ours.max_buffer_duration, ours.is_vad_buffer, ours.quality) == (12.5, False, 3)
    for name in vars(ours):
        if name != "device":
            assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.device == "cuda"
    # only what build_model reads: a knob the port would ignore is absent
    assert not {"compute_dtype", "long_audio_threshold", "chunk_duration",
                "extra"} & set(vars(ours))
    assert {"enhancement_model", "emotion_model"} <= set(vars(ours))


def test_build_model_reads_every_config_field():
    """Every field of the port's FrameworkConfig reaches the system:
    `build_model` reads each one."""
    import inspect
    from dataclasses import fields

    from targetdiarization_tpu_torch.runtime.config import FrameworkConfig

    src = inspect.getsource(tserver.build_model)
    assert [f.name for f in fields(FrameworkConfig) if f"cfg.{f.name}" not in src] == []


def test_prewarm_runs_one_pass_of_each_program(models, monkeypatch):
    """`prewarm` runs the front end, `FusedASR` and `FusedSeparation` once;
    `prewarm_streaming` the analyzer, ASR, speaker and separator rungs up
    to the rung of max_buffer_duration, at the row rungs of max_sessions."""
    ours, _ = models
    seen = []
    for obj, name in ((ours.fused, "analyze"), (ours.fused_asr, "transcribe_masked"),
                      (ours.tasr._fused_separation(), "separate_score")):
        fn = getattr(obj, name)
        monkeypatch.setattr(obj, name, lambda *a, fn=fn, name=name, **k: seen.append(name)
                            or fn(*a, **k))
    assert ours.prewarm(16000) > 0
    assert seen == ["analyze", "transcribe_masked", "separate_score"]
    monkeypatch.setattr(ours, "max_buffer_duration", 2.0)
    rows = []
    for eng, name in ((ours._stream_analyzer, "_run_batch"), (ours.tasr.asrp.asr, "_run_mb"),
                      (ours.ap.separator, "_run_mb")):
        fn = getattr(eng, name)
        monkeypatch.setattr(eng, name, lambda key, items, fn=fn, name=name: rows.append(
            (name, key, len(items))) or fn(key, items))
    assert ours.prewarm_streaming(max_sessions=2) == 2 * 2 + 2 * 2 + 2 * 2 + 1 * 2
    assert sorted(rows) == sorted(
        [("_run_batch", (b, 16000), n) for b in (16000, 32000) for n in (1, 2)]
        + [("_run_mb", b, n) for b in (16000, 32000) for n in (1, 2)]
        + [("_run_mb", 32000, n) for n in (1, 2)])
