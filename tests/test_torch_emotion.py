"""The port's emotion recognizer against the JAX package's, on the CPU.

`EmotionNet` on the shipped `checkpoints/emo-bootstrap` (dim 128, two
attention layers) and on a small random config from one flax init, the
engine's `emotion_detection` on 0.5-20 s clips across the sample rungs
(1-30 s), the empty and 44.1 kHz cases, and `ASRProcessor.emotion_detection`
with and without an engine. Inputs are synthesized speech and seeded noise;
JAX runs at full float32 matmul precision; the bf16 mode is held against the
JAX engine made under TD_COMPUTE_DTYPE=bfloat16.

Limits, and why:
- float32: the probabilities within 1e-4 (they agree to about 1e-8);
  `emotion_detection`'s scores, rounded to 4 digits, within 1e-4 (one
  step of the rounding);
- bf16: the same argmax, and the probabilities within 0.05 of the JAX bf16
  mode's. Both compute every layer in bf16, softmax included. The head's
  logits reach about 20 here, where one bf16 step is 0.125, and the two
  programs' logits part by one step in an entry or two; that moves a top
  probability near 0.8 by 0.02-0.03 (0.0216 and 0.0265 measured on 0.5 s
  clips of seeds 1 and 2; the bf16 port against its own float32 moves by
  as much). The clips above 1 s give one-hot probabilities in both.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BOOT_CHARS, synth_utterance, voice_b
from targetdiarization_tpu.models import emotion as je
from targetdiarization_tpu.models import features as jfeat
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu_torch.models import emotion as te
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.runtime.convert import emotion_net_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "emo-bootstrap")
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(seconds: float, seed: int) -> np.ndarray:
    """Utterances of the synthetic voice (every other one the second voice)
    with pauses, and a little noise."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * SR), np.float32)
    pos, k = int(0.05 * SR), 0
    while pos < len(out) - SR // 8:
        utt = synth_utterance("".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                                      for _ in range(4)), rng)[0]
        utt = voice_b(utt) if k % 2 else utt
        n = min(len(utt), len(out) - pos)
        out[pos: pos + n] = utt[:n] * rng.uniform(0.3, 1.5)
        pos, k = pos + n + int(rng.uniform(0.1, 0.5) * SR), k + 1
    return out + (0.003 * rng.standard_normal(len(out))).astype(np.float32)


def _engines(dtype: str):
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": dtype}):
        theirs = je.EmotionEngine.from_pretrained(CKPT)
    return te.EmotionEngine.from_pretrained(CKPT, device="cpu", compute_dtype=dtype), theirs


@pytest.fixture(scope="module")
def f32():
    return _engines("float32")


@pytest.fixture(scope="module")
def bf16():
    return _engines("bfloat16")


def _probs(engines, audio):
    """Both engines' raw probabilities on the same padded rung."""
    ours, theirs = engines
    t = jfeat.num_frames(len(audio))
    padded = np.pad(audio, (0, je._SAMPLE_LADDER.bucket(len(audio)) - len(audio)))[None]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(theirs._apply(theirs._params_c, jnp.asarray(padded), jnp.asarray([t])))
    return ours.probs(padded, [t]), want


CLIPS = [(0.5, 1), (0.5, 2), (1.7, 2), (3.2, 3), (6.0, 4), (12.5, 5), (20.0, 6)]


def test_shipped_checkpoint_loads_strictly():
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained

    model = from_pretrained(CKPT)
    assert isinstance(model, te.EmotionNet) and model.head.out_features == len(te.EMOTION_LABELS)
    assert te.EMOTION_LABELS == je.EMOTION_LABELS
    assert te._SAMPLE_LADDER.rungs == je._SAMPLE_LADDER.rungs


@pytest.mark.parametrize("seconds,seed", CLIPS)
def test_emotion_net_float32_matches_jax(f32, seconds, seed):
    got, want = _probs(f32, _clip(seconds, seed))
    assert got.shape == want.shape == (1, 9) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("seconds,seed", CLIPS)
def test_emotion_net_bf16_matches_jax_bf16_mode(bf16, seconds, seed):
    ours, theirs = bf16
    assert ours.compute_dtype == torch.bfloat16 and theirs.compute_dtype is jnp.bfloat16
    got, want = _probs(bf16, _clip(seconds, seed))
    assert got.argmax() == want.argmax()
    assert np.abs(got - want).max() <= 0.05, (got, want)


def test_small_random_emotion_net_matches_jax():
    """A random net (dim 64, 3 layers) whose probabilities are not near
    one-hot, on three rows of different lengths: the key mask and the
    masked mean per row."""
    jm = je.EmotionNet(dim=64, n_layers=3)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 203, 80)).astype(np.float32)
    lengths = np.array([203, 120, 3], np.int32)
    params = jm.init(jax.random.PRNGKey(1), feats, lengths)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(params, feats, lengths))
    tm = te.EmotionNet(dim=64, n_layers=3)
    tm.load_state_dict(emotion_net_state_dict(params), strict=True)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(feats), torch.from_numpy(lengths)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(want[0] - want[1]).max() > 1e-3  # the rows differ


@pytest.mark.parametrize("seconds,seed", CLIPS)
def test_emotion_detection_matches_jax(f32, seconds, seed):
    ours, theirs = f32
    audio = _clip(seconds, seed)
    with jax.default_matmul_precision("highest"):
        want = theirs.emotion_detection(audio)
    got = ours.emotion_detection(audio)
    assert got["labels"] == want["labels"] == te.EMOTION_LABELS
    assert max(abs(a - b) for a, b in zip(got["scores"], want["scores"])) <= 1e-4 + 1e-9


@pytest.mark.parametrize("n", [0, 300])
def test_emotion_detection_of_no_frame(f32, n):
    """Shorter than one 25 ms fbank frame: every label, zero scores."""
    ours, theirs = f32
    audio = np.zeros(n, np.float32)
    assert ours.emotion_detection(audio) == theirs.emotion_detection(audio) == {
        "labels": te.EMOTION_LABELS, "scores": [0.0] * 9}


def test_emotion_detection_at_44k1_matches_jax(f32):
    ours, theirs = f32
    from targetdiarization_tpu_torch.ops.resample import resample_poly_np

    audio = resample_poly_np(_clip(2.5, 7), 44100, SR)
    with jax.default_matmul_precision("highest"):
        want = theirs.emotion_detection(audio, sr=44100)
    got = ours.emotion_detection(audio, sr=44100)
    assert max(abs(a - b) for a, b in zip(got["scores"], want["scores"])) <= 1e-4 + 1e-9


def test_asr_processor_emotion_detection():
    """With the engine, its result; without one, no labels (the JAX
    processor's answer when neither an emotion engine nor SenseVoice is
    loaded)."""
    ours = ASRProcessor(emotion_model=CKPT, device="cpu", compute_dtype="float32")
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = JaxASRProcessor(emotion_model=CKPT)
    audio = _clip(2.0, 8)
    with jax.default_matmul_precision("highest"):
        want = theirs.emotion_detection(audio)
    got = ours.emotion_detection(audio)
    assert got["labels"] == want["labels"]
    assert max(abs(a - b) for a, b in zip(got["scores"], want["scores"])) <= 1e-4 + 1e-9
    assert ASRProcessor(device="cpu").emotion_detection(audio) == {"labels": [], "scores": []}
    with pytest.raises(FileNotFoundError, match="not found"):
        ASRProcessor(emotion_model=os.path.join(REPO, "checkpoints", "no-such"), device="cpu")
