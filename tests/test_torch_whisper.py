"""The port's Whisper-style ASR against the JAX package's, on the CPU.

The three shipped checkpoints (`whisper-bootstrap`, `whisper-v2`,
`whisper-v3`: dim 128, 3 + 2 layers, ffn 512 or 640): the encoder on
random log-mel frames of an even or an odd length (the stride-2 conv's
"SAME" pads differ), the teacher-forced logits, and the engine's greedy
ids on synthesized utterances (chip_smoke.py's copy of
`train/synth.py`), two in one padded batch. Held against the JAX engines
on the same params, not against `tests/test_asr.py`'s CER limits. JAX
runs at full float32 matmul precision.

Limits: the encoder output and logits within 1e-4 of the peak (they
agree to about 1e-5); the 64 greedy ids equal. The port decodes the
growing prefix where the JAX engine re-decodes the whole padded row each
step; the mask is causal, so a step's logits are the same. The bf16 mode
gives the JAX bf16 mode's ids on whisper-v3.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synth_utterance
from targetdiarization_tpu.models import features as jfeat
from targetdiarization_tpu.models import whisper_style as jws
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import whisper_style as tws
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.runtime.convert import whisper_state_dict
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = ("whisper-bootstrap", "whisper-v2", "whisper-v3")
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


def _ckpt(name: str) -> str:
    return os.path.join(REPO, "checkpoints", name)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


@pytest.mark.parametrize("name,frames", [("whisper-bootstrap", 100), ("whisper-v2", 101),
                                         ("whisper-v3", 101)])
def test_encoder_and_logits_match_jax(name, frames):
    rng = np.random.default_rng(frames)
    jmod, params = jax_from_pretrained(_ckpt(name))
    feats = (3.0 * rng.standard_normal((2, frames, 80)) + 5.0).astype(np.float32)
    mask = np.ones((2, frames), np.float32)
    mask[1, 63:] = 0.0
    tokens = rng.integers(0, 21001, (2, 9))
    encode = jax.jit(lambda p, f, m: jmod.apply(p, f, m, method=jws.WhisperStyleASR.encode))
    enc = np.asarray(_highest(encode, params, jnp.asarray(feats), jnp.asarray(mask)))
    logits = np.asarray(_highest(jax.jit(jmod.apply), params, jnp.asarray(feats),
                                 jnp.asarray(mask), jnp.asarray(tokens)))
    port = from_pretrained(_ckpt(name))
    assert isinstance(port, tws.WhisperStyleASR)
    with torch.inference_mode():
        got_enc = port.encode(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
        got = port(torch.from_numpy(feats), torch.from_numpy(mask), torch.from_numpy(tokens))
        last = port.decode(torch.from_numpy(tokens), torch.from_numpy(got_enc),
                           port.enc_mask(torch.from_numpy(mask), got_enc.shape[1]),
                           last_only=True)
    assert got_enc.shape == enc.shape == (2, -(-frames // 2), 128)
    assert _rel(got_enc, enc) <= 1e-4
    assert _rel(got.numpy(), logits) <= 1e-4
    torch.testing.assert_close(last, got[:, -1], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def utts():
    rng = np.random.default_rng(31)
    return [synth_utterance(t, rng)[0] for t in ("天地人", "一二三四五六", "中大小上下")]


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_greedy_ids_match_jax(name, utts):
    """Two utterances in one 4 s batch through both engines' greedy loops:
    the same 64 ids; then asr_detection's text from them, EOS-cut."""
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = jws.WhisperStyleEngine.from_pretrained(_ckpt(name))
    ours = tws.WhisperStyleEngine.from_pretrained(_ckpt(name), device="cpu",
                                                  compute_dtype="float32")
    batch = np.stack([np.pad(u, (0, 4 * SR - len(u))) for u in utts[:2]])
    ts = [jfeat.num_frames(len(u)) for u in utts[:2]]
    want = np.asarray(_highest(theirs._greedy, theirs._params_c, jnp.asarray(batch),
                               jnp.asarray(ts)))
    got = ours.greedy(batch, ts)
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_array_equal(got, want)
    eos = ours.tokenizer.eos_id
    assert (got == eos).any(axis=1).all()  # every row ends within 64 steps
    for row, u in zip(want, utts[:2]):
        ids = list(row[: list(row).index(eos)])
        assert ours.asr_detection(u) == [{"text": theirs.tokenizer.decode(ids), "timestamp": []}]


def test_converter_takes_the_engine_layers():
    """A random WhisperStyleASR of another geometry loads strictly from a
    flax init through the converter."""
    kw = dict(vocab_size=50, dim=32, heads=2, ffn=48, enc_layers=2, dec_layers=3, max_tokens=16)
    jmod = jws.WhisperStyleASR(**kw)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12, 80)),
                                jnp.ones((1, 12)), jnp.zeros((1, 4), jnp.int32))
    port = tws.WhisperStyleASR(**kw)
    port.load_state_dict(whisper_state_dict(jax.tree_util.tree_map(np.asarray, params)),
                         strict=True)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((1, 12, 80)).astype(np.float32)
    toks = rng.integers(0, 50, (1, 5))
    want = np.asarray(_highest(jax.jit(jmod.apply), params, jnp.asarray(feats),
                               jnp.ones((1, 12)), jnp.asarray(toks)))
    with torch.inference_mode():
        got = port(torch.from_numpy(feats), torch.ones(1, 12), torch.from_numpy(toks)).numpy()
    assert _rel(got, want) <= 1e-4


def test_processor_selects_whisper_and_splits_timestamps(utts):
    """ASRProcessor with a whisper engine name loads `WhisperStyleEngine`;
    it has no batch method or forced alignment, so the batch runs one call
    an utterance and timestamp_prediction takes the VAD split."""
    vad = _ckpt("vad-bootstrap")
    ours = ASRProcessor(vad_model=vad, asr_model=_ckpt("whisper-v2"), asr_engine="whisper_v2",
                        device="cpu", compute_dtype="float32")
    assert isinstance(ours.asr, tws.WhisperStyleEngine)
    batch = ours.asr_detection_batch(utts)
    assert batch == [ours.asr_detection(u)[0] for u in utts]
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = JaxASRProcessor(vad_model=vad, asr_model=_ckpt("whisper-v2"),
                                 asr_engine="whisper_v2")
    clip = np.concatenate([np.zeros(SR // 2, np.float32), utts[1]])
    got = ours.timestamp_prediction(clip, "一二三")
    assert got == _highest(theirs.timestamp_prediction, clip, "一二三") and len(got) == 3
    assert ours.emotion_detection(utts[0]) == {"labels": [], "scores": []}


def test_bf16_greedy_ids_match_jax_bf16_mode(utts):
    """whisper-v3 in bf16: the JAX engine casts the features and the weights
    only, so its decoder runs the token embedding and the first block's
    self-attention in bf16 and the rest in float32; the port's engine keeps
    those types, and three utterances give the same 64 ids."""
    name = _ckpt("whisper-v3")
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "bfloat16"}):
        theirs = jws.WhisperStyleEngine.from_pretrained(name)
    ours = tws.WhisperStyleEngine.from_pretrained(name, device="cpu", compute_dtype="bfloat16")
    block = ours.model.dec_blocks[0]
    assert ours.model.tok_embed.weight.dtype == block.self_attn.query.weight.dtype == \
        block.cross_attn.query.weight.dtype == torch.bfloat16
    assert block.cross_attn.key.weight.dtype == ours.model.conv1.weight.dtype == torch.float32
    batch = np.stack([np.pad(u, (0, 4 * SR - len(u))) for u in utts])
    ts = [jfeat.num_frames(len(u)) for u in utts]
    want = np.asarray(_highest(theirs._greedy, theirs._params_c, jnp.asarray(batch),
                               jnp.asarray(ts)))
    np.testing.assert_array_equal(ours.greedy(batch, ts), want)
