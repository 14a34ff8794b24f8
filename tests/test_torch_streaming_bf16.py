"""The streaming slice in bf16 against the JAX package's bf16 mode, on the CPU:
`StreamChunkAnalyzer` (the VAD's speech probabilities of buffer and chunk,
and the cosine between their speaker embeddings, that R2-R5 read) and one
`infer_stream` session end to end. Every engine of both systems computes
in bf16 (the JAX engines made under TD_COMPUTE_DTYPE=bfloat16), as the
port's `build_model()` does on the card; both systems are the servers'
`build_model()` with one small random separator
(`test_torch_stream_systems.py`). Inputs are synthesized voices from
numpy seeds: the analyzer's items of `test_torch_target_asr.py`, and the
6 s dialogue with an 8 s enrollment of `test_torch_streaming.py`.

Limits, and why:
- the analyzer: the cosine within 1e-3 of the JAX bf16 pass (2.1e-5
  measured over the four items). The speech probabilities of a bf16 VAD
  depart from float32 ones by up to 0.22 at the frames where speech
  starts or ends, in the JAX package too (its bf16 pass against its own
  float32 pass on these items). So the port's bf16 probabilities are
  held to the JAX float32 pass within the JAX bf16 pass's own departure
  plus 0.05 (0.0365 more measured, on one frame of one item), and to
  the JAX bf16 pass's decision at 0.5 on all but 2 % of the frames (3 of
  248 measured; the JAX bf16 pass differs from its float32 pass on 1);
- the session: the same flush decisions chunk by chunk, the same yielded
  sequence of speakers and types, and the texts at a character error
  rate of at most 0.3 (0 measured: the same texts), the limits of the
  offline bf16 test (`test_torch_offline_bf16.py`); the JAX run must take
  none of its error branches. That test's 10 ms on timeranges does not
  hold here: the last flush's segment ends 50 ms earlier in the port.
  There the separated buffers of the two bf16 programs part by 0.17 % of
  their peak, and that puts one VAD frame at 0.349 in the port and 0.408
  in JAX against the segmenter's 0.35 closing threshold, which moves
  the end of the silence run by five frames. So each flush's VAD input is
  held to the JAX one at 30 dB SI-SDR or more (43.0-78.8 dB
  measured), the port's VAD on the JAX package's buffer gives the JAX
  package's segments, and the timeranges are held within 60 ms."""

import contextlib
import io
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cer, dialogue, enrollment, si_sdr, strip_punct
from targetdiarization_tpu.models.speaker import SpeakerEngine as JaxSpeakerEngine
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.pipeline import fused as jfused
from targetdiarization_tpu_torch.pipeline import fused as tfused
from test_torch_stream_systems import stream_systems
from test_torch_target_asr import CKPT, _items

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    ours, theirs = stream_systems("bfloat16")
    assert ours.tasr.asrp.vad.compute_dtype == torch.bfloat16
    assert ours.ap.separator.compute_dtype == torch.bfloat16
    assert theirs.tasr.asrp.vad.compute_dtype is jnp.bfloat16
    assert theirs.ap.separator.compute_dtype is jnp.bfloat16
    assert theirs._stream_analyzer is not None  # its constructor took no error branch
    return ours, theirs


@pytest.fixture(scope="module")
def jax_float32_analyzer():
    """The JAX package's analyzer in float32: the reference both bf16 modes
    depart from."""
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        return jfused.StreamChunkAnalyzer(JaxVADEngine.from_pretrained(CKPT["vad"]),
                                          JaxSpeakerEngine.from_pretrained(CKPT["spk"]))


@pytest.mark.parametrize("rows", [1, 4])
def test_stream_chunk_analyzer_bf16_matches_jax_bf16_mode(systems, jax_float32_analyzer, rows):
    ours, theirs = (s._stream_analyzer for s in systems)
    items = _items()[:rows]
    key = (tfused._LADDER.bucket(64000), 16000)
    got, want = ours._run_batch(key, items), theirs._run_batch(key, items)
    with jax.default_matmul_precision("highest"):
        ref = jax_float32_analyzer._run_batch(key, items)
    for g, w, r in zip(got, want, ref):
        for k in ("probs_comb", "probs_chunk"):
            assert g[k].shape == w[k].shape == r[k].shape
            own = np.abs(w[k] - r[k]).max()  # the JAX bf16 mode's own departure
            assert np.abs(g[k] - r[k]).max() <= own + 0.05, k
            assert np.mean((g[k] >= 0.5) != (w[k] >= 0.5)) <= 0.02, k
        assert abs(g["similarity"] - w["similarity"]) <= 1e-3


def _chunks(audio):
    return (audio[i: i + SR] for i in range(0, len(audio), SR))


def _session(model, audio, enroll):
    """(yielded entries, flush decisions in order, (VAD input, segments) of
    each of the flushes' `vad_detection` calls) of one synchronous session."""
    decisions, vad_calls = [], []
    decide, detect = model.should_wait_for_next_chunk, model.tasr.asrp.vad_detection

    def recorded(state, is_silence=False):
        wait = decide(state, is_silence=is_silence)
        decisions.append(wait)
        return wait

    def detected(audio_data, sampling_rate=16000, **kw):
        segs = detect(audio_data, sampling_rate, **kw)
        vad_calls.append((np.array(audio_data, np.float32), segs))
        return segs

    model.should_wait_for_next_chunk = recorded
    model.tasr.asrp.vad_detection = detected
    model.async_flush = False
    try:
        out = [(spk, [{k: r[k] for k in ("speaker", "timerange", "text", "type")} for r in res])
               for spk, res, _ in model.infer_stream(_chunks(audio), target_file=enroll)]
    finally:
        del model.should_wait_for_next_chunk, model.tasr.asrp.vad_detection
    return out, decisions, vad_calls


def test_infer_stream_bf16_matches_jax_bf16_mode(systems):
    ours, theirs = systems
    audio, enroll = dialogue(6.0, seed=1, overlap=True), enrollment(8.0, seed=9)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want, want_dec, want_vad = _session(theirs, audio, enroll)
    assert "Failed in func" not in buf.getvalue(), buf.getvalue()
    got, got_dec, got_vad = _session(ours, audio, enroll)
    assert got_dec == want_dec and len(want) >= 3, (got_dec, want_dec)
    assert [(s, [(r["speaker"], r["type"]) for r in res]) for s, res in got] == \
        [(s, [(r["speaker"], r["type"]) for r in res]) for s, res in want]
    assert len(got_vad) == len(want_vad) > 0
    for (g_audio, _), (w_audio, w_segs) in zip(got_vad, want_vad):
        assert g_audio.shape == w_audio.shape and si_sdr(g_audio, w_audio) >= 30.0
        assert ours.tasr.asrp.vad_detection(w_audio) == w_segs
    for (_, gr), (_, wr) in zip(got, want):
        for g, w in zip(gr, wr):
            assert max(abs(a - b) for a, b in zip(g["timerange"], w["timerange"])) <= 0.06
    text_g = "".join(strip_punct(r["text"]) for _, res in got for r in res)
    text_w = "".join(strip_punct(r["text"]) for _, res in want for r in res)
    assert cer(text_w, text_g) <= 0.3, (got, want)
