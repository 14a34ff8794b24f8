"""CIF forced alignment and the VAD's helpers against the JAX package, on the
CPU: `CIFPredictor` with `target_len`, `ASREngine.force_align`,
`ASRProcessor.timestamp_prediction` in both branches (the forced
alignment, and the VAD-weighted even split when the alignment falls short
or there is no Paraformer), and `VADEngine.get_speech_timestamps` and
`is_speech`.

Inputs are synthesized utterances of the bootstrap characters (the
shipped `asr-bootstrap` and `vad-bootstrap` were trained on such speech)
from numpy seeds; JAX runs at full float32 matmul precision, and its bf16
mode is built under TD_COMPUTE_DTYPE=bfloat16.

Limits, and why:
- float32: the same fire frames, so the same timestamps, and the same
  branch. The scaled alphas are float32 in both packages (the encoder's
  float32 stream promotes the predictor), and every utterance here fires
  its full count in both;
- bf16: the same branch, and every timestamp within one LFR frame (60 ms):
  the encoders round differently, which may move a crossing by a frame.
  On these inputs both modes take the forced alignment, with timestamps
  equal to the JAX package's;
- the VAD helpers: the same segments (the speech probabilities agree to
  float32 rounding and the segmenter is the same host code).
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
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu_torch.models import asr as tasr
from targetdiarization_tpu_torch.models.vad import VADEngine
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.runtime.convert import paraformer_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {k: os.path.join(REPO, "checkpoints", f"{k}-bootstrap") for k in ("vad", "asr")}
SR = 16000
FRAME_MS = 60


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _utterance(n_chars: int, seed: int, lead: float = 0.3, tail: float = 0.4):
    """(text, audio): n_chars of the bootstrap set, with silence around."""
    rng = np.random.default_rng(seed)
    text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))] for _ in range(n_chars))
    utt = synth_utterance(text, rng)[0]
    return text, np.concatenate([np.zeros(int(lead * SR), np.float32), utt,
                                 np.zeros(int(tail * SR), np.float32)])


UTTS = [(5, 1), (9, 2), (14, 3)]


def _processors(dtype: str):
    kw = {"vad_model": CKPT["vad"], "asr_model": CKPT["asr"]}
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": dtype}):
        theirs = JaxASRProcessor(**kw)
    return ASRProcessor(**kw, device="cpu", compute_dtype=dtype), theirs


@pytest.fixture(scope="module")
def f32():
    return _processors("float32")


@pytest.fixture(scope="module")
def bf16():
    return _processors("bfloat16")


def test_cif_predictor_with_target_len_matches_jax():
    """The predictor alone on a random encoder output: alphas scaled to
    each row's target, the alphas before the scaling, the same fire
    frames, no tail frame."""
    jp = jasr.CIFPredictor(dim=32)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((3, 40, 32)).astype(np.float32)
    mask = (np.arange(40)[None, :] < np.array([40, 31, 12])[:, None]).astype(np.float32)
    target = np.array([7.0, 9.0, 3.0], np.float32)
    params = jp.init(jax.random.PRNGKey(0), enc, mask)
    with jax.default_matmul_precision("highest"):
        _, _, w_alphas, w_fire, w_n, w_raw = jp.apply(params, enc, mask, jnp.asarray(target))
    tp = tasr.CIFPredictor(dim=32)
    sd = {k[len("predictor."):]: v for k, v in
          paraformer_state_dict({"predictor": params["params"]}).items()}
    tp.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        _, g_fire, g_n, g_alphas, g_raw = tp.eval()(torch.from_numpy(enc),
                                                    torch.from_numpy(mask),
                                                    torch.from_numpy(target))
    np.testing.assert_allclose(g_alphas.numpy(), np.asarray(w_alphas), atol=1e-6)
    np.testing.assert_allclose(g_raw.numpy(), np.asarray(w_raw), atol=1e-6)
    np.testing.assert_allclose(g_alphas.sum(dim=1).numpy(), target, rtol=1e-5)
    np.testing.assert_array_equal(g_fire.numpy(), np.asarray(w_fire))
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(w_n))


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("n_chars,seed", UTTS)
def test_force_align_float32_matches_jax(f32, n_chars, seed, extra):
    """The fire frames of the JAX package for the text's count and for
    three more."""
    ours, theirs = f32
    _, audio = _utterance(n_chars, seed)
    with jax.default_matmul_precision("highest"):
        want = theirs.asr.force_align(audio, n_chars + extra)
    got = ours.asr.force_align(audio, n_chars + extra)
    assert got == want and len(got) == n_chars + extra
    assert ours.asr.force_align(audio, 0) == [] and ours.asr.force_align(audio[:300], 3) == []


@pytest.mark.parametrize("n_chars,seed", UTTS)
def test_force_align_at_one_token_a_frame(f32, n_chars, seed):
    """More tokens than LFR frames are clamped to the T frames. There the
    scaled alphas' float32 cumulative sum must reach T exactly to fire the
    last token, and each package's sum lands within rounding of it on
    either side (the port fired one more than JAX on seed 1, one fewer on
    seed 2): the same frames up to the last, and T or T - 1 entries."""
    ours, theirs = f32
    _, audio = _utterance(n_chars, seed)
    t = -(-((len(audio) - 400) // 160 + 1) // 6)
    with jax.default_matmul_precision("highest"):
        want = theirs.asr.force_align(audio, t + 100)
    got = ours.asr.force_align(audio, t + 100)
    assert {len(got), len(want)} <= {t, t - 1}
    assert got[: t - 1] == want[: t - 1]


@pytest.mark.parametrize("n_chars,seed", UTTS)
def test_timestamp_prediction_float32_matches_jax(f32, n_chars, seed):
    ours, theirs = f32
    text, audio = _utterance(n_chars, seed)
    text = text[:2] + " " + text[2:]  # a space is not aligned
    with jax.default_matmul_precision("highest"):
        want = theirs.timestamp_prediction(audio, text)
    got = ours.timestamp_prediction(audio, text)
    assert got == want and len(got) == n_chars  # the forced alignment's branch
    flat = [x for se in got for x in se]
    assert flat == sorted(flat) and flat[-1] <= len(audio) / SR * 1000


@pytest.mark.parametrize("n_chars,seed", UTTS)
def test_timestamp_prediction_bf16_matches_jax_bf16_mode(bf16, n_chars, seed):
    ours, theirs = bf16
    assert ours.asr.compute_dtype == torch.bfloat16
    assert theirs.asr.compute_dtype is jnp.bfloat16
    text, audio = _utterance(n_chars, seed)
    want = theirs.timestamp_prediction(audio, text)
    got = ours.timestamp_prediction(audio, text)
    assert len(got) == len(want) == n_chars  # both take the forced alignment
    for (gs, ge), (ws, we) in zip(got, want):
        assert abs(gs - ws) <= FRAME_MS and abs(ge - we) <= FRAME_MS


def test_timestamp_prediction_vad_split_matches_jax(f32, monkeypatch):
    """The fallback: the alignment gives fewer entries than characters (as
    where the scaled alphas' sum lands short of the last threshold), so the
    VAD's speech is split evenly over every character of the text, spaces
    included."""
    ours, theirs = f32
    text, audio = _utterance(7, 4)
    text = text[:3] + " " + text[3:]
    monkeypatch.setattr(ours.asr, "force_align", lambda a, n, sr=SR: [[0, 60]] * (n - 1))
    monkeypatch.setattr(theirs.asr, "force_align", lambda a, n, sr=SR: [[0, 60]] * (n - 1))
    with jax.default_matmul_precision("highest"):
        want = theirs.timestamp_prediction(audio, text)
    got = ours.timestamp_prediction(audio, text)
    assert got == want and len(got) == len(text) == 8
    segs = ours.vad_detection(audio)
    assert got[0][0] == int(segs[0][0] * 1000)


@pytest.mark.parametrize("vad", [True, False])
def test_timestamp_prediction_without_paraformer_matches_jax(vad):
    """No ASR engine: the even split over the VAD's speech, or over the
    whole clip without a VAD (the port's; the JAX processor always has a
    VAD, so that case is held to the whole clip's split)."""
    text, audio = _utterance(6, 5)
    ours = ASRProcessor(vad_model=CKPT["vad"] if vad else "", device="cpu",
                        compute_dtype="float32")
    got = ours.timestamp_prediction(audio, text)
    assert len(got) == len(text) and ours.timestamp_prediction(audio, "") == []
    if vad:
        with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
            theirs = JaxASRProcessor(vad_model=CKPT["vad"])
        with jax.default_matmul_precision("highest"):
            assert got == theirs.timestamp_prediction(audio, text)
    else:
        per = len(audio) / SR / len(text)
        assert got == [[int(i * per * 1000), int((i + 1) * per * 1000)] for i in range(len(text))]


# ---------------- VAD helpers ----------------


@pytest.fixture(scope="module")
def vads():
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = JaxVADEngine.from_pretrained(CKPT["vad"])
    return VADEngine.from_pretrained(CKPT["vad"], device="cpu", compute_dtype="float32"), theirs


def _speech_with_gaps() -> np.ndarray:
    parts = []
    for seed in (6, 7, 8):
        parts += [_utterance(5, seed, lead=0.6, tail=0.0)[1]]
    return np.concatenate(parts + [np.zeros(SR // 2, np.float32)])


@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("seconds", [False, True])
def test_get_speech_timestamps_matches_jax(vads, sr, seconds):
    ours, theirs = vads
    audio = _speech_with_gaps()
    if sr != SR:
        audio = audio[::2].copy()
    with jax.default_matmul_precision("highest"):
        want = theirs.get_speech_timestamps(audio, sr=sr, return_seconds=seconds)
    got = ours.get_speech_timestamps(audio, sr=sr, return_seconds=seconds)
    assert got == want and len(got) >= 2
    kind = float if seconds else int
    assert all(isinstance(d["start"], kind) and d["start"] < d["end"] for d in got)
    over = ours.get_speech_timestamps(audio, sr=sr, max_end_silence_time=2.0)
    assert len(over) < len(got)


@pytest.mark.parametrize("case", ["speech", "silence", "short", "sparse"])
def test_is_speech_matches_jax(vads, case):
    ours, theirs = vads
    speech = _speech_with_gaps()
    audio = {"speech": speech, "silence": np.zeros(SR, np.float32),
             "short": speech[:200],
             "sparse": np.concatenate([speech[: SR // 2], np.zeros(8 * SR, np.float32)])}[case]
    with jax.default_matmul_precision("highest"):
        want = theirs.is_speech(audio)
    assert ours.is_speech(audio) is want
    assert want is (case == "speech")
    assert ours.is_speech(audio, min_ratio=0.03) is theirs.is_speech(audio, min_ratio=0.03)
