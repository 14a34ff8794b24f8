"""The port's SenseVoice against the JAX package's, on the CPU.

The model on the shipped `checkpoints/sv-bootstrap` (dim 192, 6 SAN-M
layers, with `cmvn.npz`) and on a 2-layer random config from one flax
init; the engine's results (text, `raw_text`, language, emotion, event),
its batch path and its coalesced rows (`_run_mb`); the bf16 mode against
the JAX engine made under TD_COMPUTE_DTYPE=bfloat16; and the processor's
SenseVoice branches: emotion, language, and `timestamp_prediction`'s VAD
split (SenseVoice has no CIF to align with). Inputs are synthesized
speech (chip_smoke.py's copy of `train/synth.py`) from seeds; JAX runs at
full float32 matmul precision.

Limits: float32 CTC and tag logits within 1e-4 of the peak (they agree to
about 1e-6), texts and tags equal; bf16 texts and tags equal to the JAX
bf16 mode's (both compute `in_proj` in bf16 and the rest in float32 from
bf16-rounded weights).
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BOOT_CHARS, synth_utterance
from targetdiarization_tpu.models import asr as jasr
from targetdiarization_tpu.models import features as jfeat
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.runtime.params import load_checkpoint, upgrade_scan_layout
from targetdiarization_tpu.runtime.precision import quantize_i16 as jax_quantize_i16
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import asr as tasr
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.runtime.convert import sensevoice_state_dict
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "sv-bootstrap")
VAD = os.path.join(REPO, "checkpoints", "vad-bootstrap")
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker (most
    of all the many small ops of a greedy loop)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def utts():
    """Four utterances of 3-12 characters (about 1-3.5 s), seed 21."""
    rng = np.random.default_rng(21)
    texts = ["三王口", "天地人日月", "一二三四五六七", "中大小上下左右心口手一二"]
    assert all(c in BOOT_CHARS for t in texts for c in t)
    return [synth_utterance(t, rng)[0] for t in texts]


def _engines(dtype: str):
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": dtype}):
        theirs = jasr.ASREngine.from_pretrained(CKPT)
    return tasr.ASREngine.from_pretrained(CKPT, device="cpu", compute_dtype=dtype), theirs


@pytest.fixture(scope="module")
def f32():
    return _engines("float32")


def _features(audio_rows: np.ndarray, ts: list):
    """The JAX engine's features and mask for (rows, bucket) audio."""
    with np.load(os.path.join(CKPT, "cmvn.npz")) as z:
        mean, istd = z["mean"], z["istd"]
    audio = jax_quantize_i16(audio_rows).astype(np.float32) / 32768.0
    with jax.default_matmul_precision("highest"):
        feats = jfeat.apply_cmvn(jfeat.lfr(jfeat.fbank(jnp.asarray(audio)), 7, 6), mean, istd)
    mask = (np.arange(feats.shape[1])[None, :] < np.asarray(ts)[:, None]).astype(np.float32)
    return np.array(feats), mask


def test_shipped_checkpoint_loads_both_layouts():
    """sv-bootstrap's per-layer keys (encoder/block_i) and the stacked scan
    layout give one state dict, which loads strictly."""
    legacy, meta = load_checkpoint(CKPT)
    assert meta["model_name"] == "SenseVoice" and "block_0" in legacy["params"]["encoder"]
    stacked = upgrade_scan_layout("SenseVoice", load_checkpoint(CKPT)[0])
    assert "block" in stacked["params"]["encoder"]["blocks"]
    sd_legacy = sensevoice_state_dict(legacy)
    sd_stacked = sensevoice_state_dict(jax.tree_util.tree_map(np.asarray, stacked))
    assert sd_legacy.keys() == sd_stacked.keys()
    for k in sd_legacy:
        torch.testing.assert_close(sd_legacy[k], sd_stacked[k], rtol=0, atol=0)
    model = from_pretrained(CKPT)
    assert isinstance(model, tasr.SenseVoice) and len(model.encoder.blocks) == 6
    assert model.tag_queries.shape == (4, 560)


def test_shipped_model_matches_jax(utts):
    """Two utterances at the 4 s rung, one row padded: CTC and tag logits
    within 1e-4, the same argmax on the valid frames."""
    model, params = jax_from_pretrained(CKPT)
    rows = np.stack([np.pad(u, (0, 4 * SR - len(u))) for u in utts[1:3]])
    ts = [-(-jfeat.num_frames(len(u)) // 6) for u in utts[1:3]]
    feats, mask = _features(rows, ts)
    want = jax.tree_util.tree_map(np.asarray, _highest(jax.jit(model.apply), params,
                                                       jnp.asarray(feats), jnp.asarray(mask)))
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in from_pretrained(CKPT)(torch.from_numpy(feats),
                                                              torch.from_numpy(mask)).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and _rel(got[k], want[k]) <= 1e-4, k
        np.testing.assert_array_equal(got[k].argmax(-1), want[k].argmax(-1))


def test_small_random_model_matches_jax():
    """A 2-layer, dim-64 SenseVoice from one flax init, perturbed, on random
    features with a padded row."""
    rng = np.random.default_rng(5)
    kw = dict(vocab_size=300, dim=64, heads=4, ffn=128, enc_layers=2)
    jmod = jasr.SenseVoice(**kw)
    feats = rng.standard_normal((2, 37, 560)).astype(np.float32)
    mask = np.ones((2, 37), np.float32)
    mask[1, 21:] = 0.0
    params = jax.jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(mask))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    want = jax.tree_util.tree_map(np.asarray, _highest(jax.jit(jmod.apply), params,
                                                       jnp.asarray(feats), jnp.asarray(mask)))
    port = tasr.SenseVoice(**kw)
    port.load_state_dict(sensevoice_state_dict(jax.tree_util.tree_map(np.asarray, params)),
                         strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(feats), torch.from_numpy(mask))
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 1e-4, k


def test_engine_results_match_jax(f32, utts):
    """One call per utterance: text, raw_text, language, emotion and event
    equal, no timestamps; the model transcribes something."""
    ours, theirs = f32
    assert ours.engine == theirs.engine == "sensevoice"
    for u in utts:
        got, want = ours.asr_detection(u), _highest(theirs.asr_detection, u)
        assert got == want
        assert set(got[0]) == {"text", "timestamp", "raw_text", "language", "emotion", "event"}
        assert got[0]["timestamp"] == [] and got[0]["raw_text"].endswith(got[0]["text"])
    assert any(ours.asr_detection(u)[0]["text"] for u in utts)


def test_engine_batch_and_rows_match(f32, utts):
    """asr_detection_batch equals the JAX package's and the single calls;
    `_run_mb` (three rows padded to the 4-row rung) gives each item its
    single result."""
    ours, theirs = f32
    got = ours.asr_detection_batch(utts)
    assert got == _highest(theirs.asr_detection_batch, utts)
    assert got == [ours.asr_detection(u)[0] for u in utts]
    bucket = 4 * SR
    items = [(jax_quantize_i16(np.pad(u, (0, bucket - len(u)))),
              -(-jfeat.num_frames(len(u)) // 6)) for u in utts[:3]]
    assert ours._run_mb(bucket, items) == got[:3]
    assert ours.force_align(utts[0], 3) == []


def test_bf16_mode_matches_jax_bf16_mode(utts):
    ours, theirs = _engines("bfloat16")
    assert ours.compute_dtype == torch.bfloat16 and theirs.compute_dtype is jnp.bfloat16
    assert ours.model.encoder.in_proj.weight.dtype == torch.bfloat16
    assert ours.model.ctc.weight.dtype == torch.float32
    got = ours.asr_detection_batch(utts)
    assert got == _highest(theirs.asr_detection_batch, utts)
    assert [ours.asr_detection(u)[0] for u in utts] == got


@pytest.fixture(scope="module")
def processors():
    kw = dict(vad_model=VAD, asr_model=CKPT, asr_engine="sensevoice")
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = JaxASRProcessor(**kw)
    return ASRProcessor(**kw, device="cpu", compute_dtype="float32"), theirs


def test_processor_emotion_and_language_match_jax(processors, utts):
    """Without an emotion engine, emotion_detection reads SenseVoice's tag;
    detect_language of audio its language tag, of text the CJK rule."""
    ours, theirs = processors
    for u in utts[:2]:
        got = ours.emotion_detection(u)
        assert got == _highest(theirs.emotion_detection, u)
        assert got["labels"] == tasr.EMOTIONS and sum(got["scores"]) == 1.0
        assert ours.detect_language(audio_data=u) == _highest(theirs.detect_language,
                                                               audio_data=u)
    assert ours.detect_language("hello") == theirs.detect_language("hello") == "en"


def test_processor_asr_and_timestamps_match_jax(processors, utts):
    """asr_detection (one and a batch) equal; timestamp_prediction takes the
    VAD split, as the JAX processor does for an engine without forced
    alignment."""
    ours, theirs = processors
    assert ours.asr_detection(utts[1]) == _highest(theirs.asr_detection, utts[1])
    assert ours.asr_detection_batch(utts) == _highest(theirs.asr_detection_batch, utts)
    clip = np.concatenate([np.zeros(SR // 2, np.float32), utts[2], np.zeros(SR // 2, np.float32)])
    got = ours.timestamp_prediction(clip, "一二三 四五")
    assert got == _highest(theirs.timestamp_prediction, clip, "一二三 四五")
    assert len(got) == 6 and got[0][0] >= 300
