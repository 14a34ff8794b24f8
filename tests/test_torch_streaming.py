"""The streaming slice of the port against the JAX package on the CPU: the
flush cascade R1-R5, stream-mode `audio_preprocess`, and
`TargetDiarizationStream.infer_stream` end to end, sync and async, with
its sessions and flush worker. (`StreamChunkAnalyzer` and the `TargetASR`
strategies a flush runs are in `test_torch_target_asr.py`.)

Inputs are synthesized voices (`chip_smoke.dialogue`, `enrollment`) from
numpy seeds; both packages' systems are their servers' `build_model()` on
the CPU (the shipped checkpoints) with one small random separator in
place of the 256/12 one (`test_torch_stream_systems.py`), float32, the JAX
side at full matmul precision.

Limits, and why:
- the rules: the same decision as the JAX package on the same state;
- stream-mode `audio_preprocess` within 1e-4 of its peak (the separator
  agrees to float32 rounding);
- `infer_stream`: the same yielded sequence, speakers, types and texts,
  timeranges within 10 ms. It runs synchronously and with the flush
  worker; the JAX package's run must not take its error branches (its
  `audio_preprocess` prints and carries on where the port raises).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from chip_smoke import dialogue, enrollment
from targetdiarization_tpu.pipeline.streaming import StreamState as JaxStreamState
from targetdiarization_tpu_torch.pipeline.streaming import StreamState
from test_torch_stream_systems import stream_systems

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------- the systems ----------------


@pytest.fixture(scope="module")
def systems():
    """Both packages' streaming systems as their servers build them on the
    CPU, with one small random separator (`test_torch_stream_systems.py`)."""
    ours, theirs = stream_systems()
    assert theirs._stream_analyzer is not None  # its constructor took no error branch
    return ours, theirs


def _state(pkg, chunks, loudness_diff=0.0):
    state = StreamState() if pkg == "port" else JaxStreamState()
    state.vad_buffer = [np.asarray(c, np.float32) for c in chunks]
    state.buffer_duration = sum(len(c) for c in chunks) / SR
    state.system_loudness_diff = loudness_diff
    return state


def _pick(systems, pkg):
    return systems[0] if pkg == "port" else systems[1]


def _fake(probs_comb, probs_chunk, similarity):
    return lambda combined, chunk: {"probs_comb": probs_comb(len(combined) // 160),
                                    "probs_chunk": probs_chunk(len(chunk) // 160),
                                    "similarity": similarity}


def _speech_until(frames):
    def track(n):
        p = np.zeros(n, np.float32)
        p[: min(frames, n)] = 1.0
        return p
    return track


PKGS = ["port", "jax"]


@pytest.mark.parametrize("pkg", PKGS)
def test_r1_buffer_cap(systems, pkg):
    model = _pick(systems, pkg)
    state = _state(pkg, [np.zeros(SR)])
    state.buffer_duration = model.max_buffer_duration + 0.5
    assert model.should_wait_for_next_chunk(state) is False


@pytest.mark.parametrize("pkg", PKGS)
def test_empty_buffer_waits(systems, pkg):
    model = _pick(systems, pkg)
    assert model.should_wait_for_next_chunk(_state(pkg, [])) is True


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("speech_frames,flush", [(100, True), (290, False)])
def test_r2_silent_chunk_flushes_after_a_gap(systems, pkg, monkeypatch, speech_frames, flush):
    """A silent chunk flushes when the buffer's speech ended at least
    vad_min_silence (0.3 s) before its end."""
    model = _pick(systems, pkg)
    monkeypatch.setattr(model._stream_analyzer, "analyze_chunk",
                        _fake(_speech_until(speech_frames), _speech_until(0), 1.0))
    state = _state(pkg, [np.full(2 * SR, 0.1), np.full(SR, 1e-5)])
    assert model.should_wait_for_next_chunk(state, is_silence=True) is (not flush)


@pytest.mark.parametrize("pkg", PKGS)
def test_r3_no_speech_zero_substitute(systems, pkg, monkeypatch):
    model = _pick(systems, pkg)
    monkeypatch.setattr(model._stream_analyzer, "analyze_chunk",
                        _fake(_speech_until(0), _speech_until(0), 1.0))
    state = _state(pkg, [np.full(SR, 0.1)])
    assert model.should_wait_for_next_chunk(state) is True
    assert np.all(state.vad_buffer[-1] == np.float32(1e-5))


@pytest.mark.parametrize("pkg", PKGS)
def test_r4_speech_complete_flush(systems, pkg, monkeypatch):
    model = _pick(systems, pkg)
    monkeypatch.setattr(model._stream_analyzer, "analyze_chunk",
                        _fake(_speech_until(100), _speech_until(100), 1.0))
    assert model.should_wait_for_next_chunk(_state(pkg, [np.full(2 * SR, 0.1)])) is False


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("similarity,flush", [(0.0, True), (0.9, False)])
def test_r5_speaker_change(systems, pkg, monkeypatch, similarity, flush):
    """Speech to the end of the buffer: a flush on a speaker change
    (cosine below similarity_threshold 0.4), else a wait."""
    model = _pick(systems, pkg)
    monkeypatch.setattr(model._stream_analyzer, "analyze_chunk",
                        _fake(_speech_until(10 ** 6), _speech_until(10 ** 6), similarity))
    state = _state(pkg, [np.full(SR, 0.1), np.full(SR, 0.1)])
    assert model.should_wait_for_next_chunk(state) is (not flush)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("flush", [True, False])
def test_flush_rules_without_a_vad(systems, pkg, monkeypatch, flush):
    """A configuration without a VAD checkpoint has no analyzer: the whole
    buffer counts as speech, so R4 never fires and the speaker engine's
    batch decides R5 (orthogonal embeddings flush, equal ones wait)."""
    model = _pick(systems, pkg)
    monkeypatch.setattr(model.tasr.asrp, "vad", None)
    monkeypatch.setattr(model, "_stream_analyzer", None)
    e = np.eye(2, 192, dtype=np.float32)
    monkeypatch.setattr(model.tasr.spk, "embed_batch",
                        lambda clips, sr=16000: e if flush else e[[0, 0]])
    state = _state(pkg, [np.full(SR, 0.1)] * 2)
    assert model.should_wait_for_next_chunk(state) is (not flush)
    assert model.should_wait_for_next_chunk(state, is_silence=True) is True  # R2: no gap


@pytest.mark.parametrize("pkg", PKGS)
def test_loudness_gate_makes_a_quiet_chunk_silent(systems, pkg, monkeypatch):
    """With a target level set, a chunk far below it is buffered as near
    silence and decided as a silent chunk (R2)."""
    model = _pick(systems, pkg)
    seen = []
    monkeypatch.setattr(model, "should_wait_for_next_chunk",
                        lambda state, is_silence=False: seen.append(
                            (is_silence, float(state.vad_buffer[-1].max()))) or True)
    state = _state(pkg, [], loudness_diff=10.0)
    quiet = (1e-4 * np.random.default_rng(0).standard_normal(SR)).astype(np.float32)
    assert list(model.process_vad_chunk(quiet, False, state)) == []
    assert seen == [(True, pytest.approx(1e-5))]


def test_chunk_preprocess_matches_jax(systems):
    ours, theirs = systems
    chunk = (np.random.default_rng(0).standard_normal((2, 8000)) * 1000).astype(np.int16)
    got, want = ours.chunk_preprocess(chunk, 8000), theirs.chunk_preprocess(chunk, 8000)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_stream_mode_audio_preprocess_matches_jax(systems):
    """Loudness, the separator's louder stream, loudness: within 1e-4 of
    the JAX package's (whose separator agrees to float32 rounding)."""
    ours, theirs = systems
    audio = dialogue(3.0, seed=4, overlap=True)
    with jax.default_matmul_precision("highest"):
        want = theirs.audio_preprocess(audio, SR, stream_mode=True, output_audio_only=True)
    got = ours.audio_preprocess(audio, SR, stream_mode=True, output_audio_only=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------- infer_stream end to end ----------------


def _chunks(audio):
    return (audio[i: i + SR] for i in range(0, len(audio), SR))


def _strip(out):
    return [(spk, [{k: r[k] for k in ("speaker", "timerange", "text", "type")} for r in res])
            for spk, res, _ in out]


@pytest.fixture(scope="module")
def stream_inputs():
    return dialogue(6.0, seed=1, overlap=True), enrollment(8.0, seed=9)


@pytest.fixture(scope="module")
def jax_stream(systems, stream_inputs):
    """The JAX package's yielded sequence, synchronous flushes; its
    `audio_preprocess` must not have printed its error branch."""
    import contextlib
    import io

    _, theirs = systems
    audio, enroll = stream_inputs
    theirs.async_flush = False
    buf = io.StringIO()
    with jax.default_matmul_precision("highest"), contextlib.redirect_stdout(buf):
        out = _strip(theirs.infer_stream(_chunks(audio), target_file=enroll))
    assert "Failed in func" not in buf.getvalue(), buf.getvalue()
    return out


@pytest.mark.parametrize("async_flush", [False, True])
def test_infer_stream_matches_jax(systems, stream_inputs, jax_stream, async_flush, monkeypatch):
    ours, _ = systems
    audio, enroll = stream_inputs
    monkeypatch.setattr(ours, "async_flush", async_flush)
    metrics = {}
    got = _strip(ours.infer_stream(_chunks(audio), target_file=enroll, metrics=metrics))
    want = jax_stream
    assert len(got) == len(want) and len(got) >= 3, (got, want)
    assert any(r["type"] == "overlap" for _, res in want for r in res)  # a flush separated both
    assert {r["speaker"] for _, res in want for r in res} == {"0", "1"}
    for (gs, gr), (ws, wr) in zip(got, want):
        assert gs == ws and len(gr) == len(wr) == 1
        g, w = gr[0], wr[0]
        assert (g["speaker"], g["type"], g["text"]) == (w["speaker"], w["type"], w["text"])
        assert max(abs(a - b) for a, b in zip(g["timerange"], w["timerange"])) <= 0.01
    assert len(metrics["emission_s"]) == len(got)


# ---------------- sessions and the flush worker ----------------


def test_interleaved_sessions_keep_their_own_state(systems, monkeypatch):
    """Two sessions whose generators advance in turns give what each gives
    alone."""
    ours, _ = systems
    monkeypatch.setattr(ours, "async_flush", False)
    a, b = dialogue(2.0, seed=21, overlap=False), dialogue(2.0, seed=22, overlap=False)
    alone = [_strip(ours.infer_stream(_chunks(x))) for x in (a, b)]
    gens = [ours.infer_stream(_chunks(x)) for x in (a, b)]
    outs, live = [[], []], [True, True]
    while any(live):
        for i, g in enumerate(gens):
            if live[i]:
                try:
                    outs[i].append(next(g))
                except StopIteration:
                    live[i] = False
    assert [_strip(o) for o in outs] == alone


def _flush_stub(release=None, entered=None):
    def flush(pcm_chunk, is_single, state):
        if entered is not None:
            entered.set()
        if release is not None:
            assert release.wait(30)
        yield {"speaker": "1", "timerange": [0.0, 1.0], "text": "x", "type": "single",
               "audio": None}
    return flush


def test_async_flush_does_not_hold_the_intake(systems, monkeypatch):
    """While the first flush is held on its worker, the session still takes
    the next chunks; the flush's result comes out after it is released."""
    ours, _ = systems
    release, entered = threading.Event(), threading.Event()
    monkeypatch.setattr(ours, "process_single_chunk", _flush_stub(release, entered))
    monkeypatch.setattr(ours, "is_vad_buffer", False)
    monkeypatch.setattr(ours, "async_flush", True)
    monkeypatch.setattr(ours, "max_inflight_flushes", 4)
    pulled = []

    def gen():
        for k in range(3):
            yield np.full(SR, 0.1, np.float32)
            pulled.append(k)
            if k == 0:
                assert entered.wait(30)
        release.set()

    out = list(ours.infer_stream(gen()))
    assert pulled == [0, 1, 2] and len(out) == 3


@pytest.mark.parametrize("async_flush", [True, False])
def test_emission_latency_metric(systems, monkeypatch, async_flush):
    """One emission latency per yielded segment, each at least its flush's
    own duration (the chunk arrived before the flush began)."""
    import time

    ours, _ = systems
    durations = []

    def timed_flush(pcm_chunk, is_single, state):
        t = time.perf_counter()
        while time.perf_counter() - t < 0.01:
            pass
        durations.append(time.perf_counter() - t)
        yield {"speaker": "1", "timerange": [0.0, 1.0], "text": "x", "type": "single",
               "audio": None}

    monkeypatch.setattr(ours, "process_single_chunk", timed_flush)
    monkeypatch.setattr(ours, "is_vad_buffer", False)
    monkeypatch.setattr(ours, "async_flush", async_flush)
    m = {}
    out = list(ours.infer_stream(iter([np.full(SR, 0.1, np.float32)] * 3), metrics=m))
    assert len(out) == len(m["emission_s"]) == 3
    assert all(e >= d for e, d in zip(m["emission_s"], durations))


def test_four_sessions_flush_at_once(systems, monkeypatch):
    """Four sessions' flushes are in flight together: the barrier in each
    flush releases only when all four workers reach it."""
    ours, _ = systems
    barrier = threading.Barrier(4, timeout=60)
    flush = _flush_stub()

    def synced(pcm_chunk, is_single, state):
        barrier.wait()
        yield from flush(pcm_chunk, is_single, state)

    monkeypatch.setattr(ours, "process_single_chunk", synced)
    monkeypatch.setattr(ours, "is_vad_buffer", False)
    monkeypatch.setattr(ours, "async_flush", True)
    results, errors = [None] * 4, []

    def run(i):
        try:
            results[i] = list(ours.infer_stream(iter([np.full(SR, 0.1, np.float32)])))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not barrier.broken
    assert all(r is not None and len(r) == 1 for r in results)
