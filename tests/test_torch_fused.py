"""The slice as a whole: `FusedFrontend.analyze` and `enroll` of the port
against the JAX package's on the CPU, with all four shipped checkpoints
(`checkpoints/{den,vad,seg,spk}-bootstrap`) in float32, on a synthesized
two-voice mix (5 s, the 8 s rung) made from a seed.

Limits, and why:
- the analysed int16 track within 1 LSB, on under 1 % of the samples: the
  loudness gain and the denoiser agree to float32 rounding, which moves a
  few samples across a rounding edge;
- embeddings at cosine >= 0.9999, window times equal;
- `vad_probs` within 1e-2 and `seg_act` within 2e-3: the two packages'
  float32 fbanks of the same samples differ by up to about 4e-3 in
  low-energy bins (each is that far from float64; the ASR slice's
  `test_fbank_float32_error_is_shared`), which moves the VAD's speech
  probability by up to about 3e-3. The port's models on the JAX
  package's own features of its own track are held within 1e-4 of its
  outputs (`test_heads_on_the_jax_features_match_jax`).
The windowing above 30 s is tested with both packages' `_LADDER` cut to a
2 s top rung.
"""

import os

import jax
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import denoise as jden
from targetdiarization_tpu.models import diarization as jdia
from targetdiarization_tpu.models import features as jfeat
from targetdiarization_tpu.models import speaker as jspk
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.pipeline import fused as jfused
from targetdiarization_tpu.runtime.buckets import BucketLadder as JaxBucketLadder
from targetdiarization_tpu.train import synth
from targetdiarization_tpu_torch.models.denoise import DenoiseEngine
from targetdiarization_tpu_torch.models.diarization import SegmentationEngine
from targetdiarization_tpu_torch.models.speaker import SpeakerEngine
from targetdiarization_tpu_torch.models.vad import VADEngine
from targetdiarization_tpu_torch.pipeline import fused as tfused
from targetdiarization_tpu_torch.runtime.buckets import BucketLadder

torch.set_num_threads(2)  # beside the other test workers' threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {k: os.path.join(REPO, "checkpoints", f"{k}-bootstrap")
        for k in ("den", "vad", "seg", "spk")}
SR = 16000


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _two_voices(seconds: float, seed: int) -> np.ndarray:
    """Utterances of two voices in turns, each overlapping the last; the
    second voice is the first's synthesis played 1.25 x faster (higher
    pitch and formants)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * SR), np.float32)
    pos, voice = int(0.2 * SR), 0
    while pos < len(out) - SR // 4:
        a = synth.synth_utterance(synth.random_text(rng, 4, 8), rng)[0]
        if voice:
            a = np.interp(np.arange(0, len(a), 1.25), np.arange(len(a)), a).astype(np.float32)
        n = min(len(a), len(out) - pos)
        out[pos: pos + n] += a[:n]
        pos += int(0.75 * n) + 1
        voice ^= 1
    return out


@pytest.fixture(scope="module")
def frontends():
    ours = tfused.FusedFrontend(
        DenoiseEngine.from_pretrained(CKPT["den"], device="cpu", compute_dtype="float32"),
        VADEngine.from_pretrained(CKPT["vad"], device="cpu", compute_dtype="float32"),
        SegmentationEngine.from_pretrained(CKPT["seg"], device="cpu", compute_dtype="float32"),
        SpeakerEngine.from_pretrained(CKPT["spk"], device="cpu", compute_dtype="float32"))
    theirs = jfused.FusedFrontend(
        jden.DenoiseEngine.from_pretrained(CKPT["den"]),
        JaxVADEngine.from_pretrained(CKPT["vad"]),
        jdia.SegmentationEngine.from_pretrained(CKPT["seg"]),
        jspk.SpeakerEngine.from_pretrained(CKPT["spk"]))
    return ours, theirs


@pytest.fixture(scope="module")
def mix():
    return _two_voices(5.0, seed=5)


@pytest.fixture(scope="module")
def analyzed(frontends, mix):
    ours, theirs = frontends
    with jax.default_matmul_precision("highest"):
        want = theirs.analyze(mix)
    return ours.analyze(mix), want


def _same_track(got, want):
    lsb = np.abs(got.astype(np.float64) - want) * 32768
    assert got.shape == want.shape
    assert lsb.max() <= 1.0 and (lsb > 0.5).mean() < 0.01


def _same_analysis(got, want):
    _same_track(got["audio"], want["audio"])
    assert got["n_samples"] == want["n_samples"]
    assert got["vad_probs"].shape == want["vad_probs"].shape
    assert np.abs(got["vad_probs"] - want["vad_probs"]).max() <= 1e-2
    assert got["seg_act"].shape == want["seg_act"].shape
    assert np.abs(got["seg_act"] - want["seg_act"]).max() <= 2e-3
    assert got["win_times"] == want["win_times"] and len(got["win_times"]) > 0
    assert got["win_embs"].shape == want["win_embs"].shape
    assert _cos(got["win_embs"], want["win_embs"]).min() >= 0.9999


def test_analyze_matches_jax(analyzed):
    got, want = analyzed
    _same_analysis(got, want)
    assert got["seg_act"].shape[0] == len(got["vad_probs"]) // 4


def test_analyze_returns_the_device_track(analyzed):
    got, _ = analyzed
    dev = got["audio_dev_i16"]
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int16
    assert dev.shape == (tfused._LADDER.bucket(got["n_samples"]),)
    np.testing.assert_array_equal(dev[:got["n_samples"]].numpy() / 32768.0, got["audio"])
    assert not dev[got["n_samples"]:].any()


def _same_heads_on_jax_features(ours, want):
    """The port's VAD, segmentation and window embeddings on the JAX
    package's fbank of its own analysed track: within 1e-4 of its outputs."""
    n = want["n_samples"]
    bucket = tfused._LADDER.bucket(n)
    track = np.pad(want["audio"], (0, bucket - n))[None]
    with jax.default_matmul_precision("highest"):
        feats = np.array(jfeat.fbank(track))
    with torch.inference_mode():
        heads = {k: v.numpy() for k, v in
                 ours._heads(torch.from_numpy(feats), n, bucket).items()}
    t = len(want["vad_probs"])
    assert np.abs(heads["vad_probs"][:t] - want["vad_probs"]).max() <= 1e-4
    if want["seg_act"] is not None:
        assert np.abs(heads["seg_act"][:len(want["seg_act"])] - want["seg_act"]).max() <= 1e-4
    k = len(want["win_embs"])
    assert _cos(heads["win_embs"][:k], want["win_embs"]).min() >= 0.99999


def test_heads_on_the_jax_features_match_jax(frontends, analyzed):
    _same_heads_on_jax_features(frontends[0], analyzed[1])


@pytest.mark.parametrize("clip", ["voice", "voice inside silence"])
def test_enroll_matches_jax(frontends, mix, clip):
    """A 3 s clip, and 1.5 s of it inside a second of silence on each side
    (the trim to the speech frames moves them to the front)."""
    ours, theirs = frontends
    x = mix[:3 * SR] if clip == "voice" else np.pad(mix[SR // 2: 2 * SR], SR)
    with jax.default_matmul_precision("highest"):
        want = theirs.enroll(x)
    got = ours.enroll(x)
    _same_track(got["audio"], want["audio"])
    assert got["vad_probs"].shape == want["vad_probs"].shape
    assert np.abs(got["vad_probs"] - want["vad_probs"]).max() <= 1e-2
    assert got["emb"].shape == (192,) and np.isfinite(got["emb"]).all()
    assert _cos(got["emb"], want["emb"]) >= 0.9999


def test_windowing_above_the_top_rung_matches_jax(frontends, mix, monkeypatch):
    """With a 2 s top rung, 5 s is analysed in 2 s, 2 s and 1 s parts whose
    outputs are concatenated (window times offset by each part's start)."""
    ours, theirs = frontends
    monkeypatch.setattr(tfused, "_LADDER", BucketLadder((SR, 2 * SR)))
    monkeypatch.setattr(jfused, "_LADDER", JaxBucketLadder((SR, 2 * SR)))
    with jax.default_matmul_precision("highest"):
        want = theirs.analyze(mix)
    got = ours.analyze(mix)
    assert got["audio_dev_i16"] is None and want["audio_dev_i16"] is None
    _same_analysis(got, want)
    assert got["win_times"][-1][0] >= 2.0


def test_spectral_gate_front_end_without_segmentation_matches_jax(frontends, mix):
    """With no denoiser the spectral gate runs. Its gated track holds more
    near-silent frames, where the two fbanks' float32 difference and the
    1-LSB samples move the VAD's probability by up to about 0.12; so the
    VAD is held on the JAX package's own features (within 1e-4)."""
    ours, theirs = frontends
    ours = tfused.FusedFrontend(None, ours.vad, None, ours.spk)
    theirs = jfused.FusedFrontend(None, theirs.vad, None, theirs.spk)
    with jax.default_matmul_precision("highest"):
        want = theirs.analyze(mix[:3 * SR])
    got = ours.analyze(mix[:3 * SR])
    _same_track(got["audio"], want["audio"])
    assert got["seg_act"] is None and want["seg_act"] is None
    assert got["vad_probs"].shape == want["vad_probs"].shape
    assert _cos(got["win_embs"], want["win_embs"]).min() >= 0.9999
    _same_heads_on_jax_features(ours, want)


def test_frontend_needs_vad_and_speaker_engines(frontends):
    ours, _ = frontends
    for vad, spk in ((None, ours.spk), (ours.vad, None)):
        with pytest.raises(ValueError, match="needs VAD and speaker"):
            tfused.FusedFrontend(ours.denoiser, vad, ours.seg, spk)
