"""The overlap branch's device passes against the JAX package's:
`FusedSeparation.separate_score`, `TargetASR.multi_speakers_separate_batch`
in both of its branches, and `FusedASR.transcribe_masked`.

The separator and the restorer are small random models (a 2-layer
MossFormer2 of width 64 and a 1-layer Apollo of width 16 at 16 kHz, one
flax init converted by `runtime/convert.py`), so that a batch of four
clips runs in seconds on the CPU; the VAD, speaker, Paraformer and
punctuation engines are the shipped `checkpoints/*-bootstrap`. Clips are
synthesized speech from a numpy seed. JAX runs at full float32 matmul
precision.

Limits, and why:
- streams within 1 LSB of int16 (the int16 round trip of float32 values
  that agree to rounding moves a few samples across an edge);
- stream embeddings at cosine >= 0.9999 and VAD segments within 10 ms
  (one frame);
- `FusedASR` on the same int16 buffer: texts, timestamps and punctuation
  classes equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BOOT_CHARS, synth_utterance, voice_b
from targetdiarization_tpu.models import restoration as jr
from targetdiarization_tpu.models import separation as jsep
from targetdiarization_tpu.models.asr import ASREngine as JaxASREngine
from targetdiarization_tpu.models.punctuation import PunctuationEngine as JaxPuncEngine
from targetdiarization_tpu.models.speaker import SpeakerEngine as JaxSpeakerEngine
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.pipeline import fused as jfused
from targetdiarization_tpu.pipeline.target_asr import TargetASR as JaxTargetASR
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu_torch.models import restoration as tr
from targetdiarization_tpu_torch.models import separation as tsep
from targetdiarization_tpu_torch.models.asr import ASREngine
from targetdiarization_tpu_torch.models.punctuation import PunctuationEngine
from targetdiarization_tpu_torch.models.speaker import SpeakerEngine
from targetdiarization_tpu_torch.models.vad import VADEngine
from targetdiarization_tpu_torch.pipeline import fused as tfused
from targetdiarization_tpu_torch.pipeline.target_asr import TargetASR
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from targetdiarization_tpu_torch.runtime.convert import apollo_state_dict, mossformer2_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {k: os.path.join(REPO, "checkpoints", f"{k}-bootstrap")
        for k in ("vad", "spk", "asr", "punc")}
SEP = dict(dim=64, enc_channels=64, num_blocks=2, group_size=32, qk_dim=32, fsmn_inner=64)
REST = dict(sr=16000, win_ms=20, feature_dim=16, layer=1)
SR = 16000
F32 = {"device": "cpu", "compute_dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small_models():
    with jax.default_matmul_precision("highest"):
        sep_mod = jsep.MossFormer2(**SEP)
        sep_p = jax.jit(sep_mod.init)(jax.random.PRNGKey(1), jnp.zeros((1, 1024)))
        rest_mod = jr.Apollo(**REST)
        rest_p = jax.jit(rest_mod.init)(jax.random.PRNGKey(2), jnp.zeros((1, 1280)))
    sep = tsep.MossFormer2(**SEP)
    sep.load_state_dict(mossformer2_state_dict(sep_p), strict=True)
    rest = tr.Apollo(**REST)
    rest.load_state_dict(apollo_state_dict(rest_p), strict=True)
    return (tsep.SeparationEngine(sep.eval(), **F32), tr.RestorationEngine(rest.eval(), **F32),
            jsep.SeparationEngine(params=sep_p, model=sep_mod),
            jr.RestorationEngine(params=rest_p, model=rest_mod))


@pytest.fixture(scope="module")
def engines():
    sep, rest, jsep_eng, jrest = _small_models()
    ours = {"sep": sep, "rest": rest, "spk": SpeakerEngine.from_pretrained(CKPT["spk"], **F32),
            "vad": VADEngine.from_pretrained(CKPT["vad"], **F32)}
    theirs = {"sep": jsep_eng, "rest": jrest,
              "spk": JaxSpeakerEngine.from_pretrained(CKPT["spk"]),
              "vad": JaxVADEngine.from_pretrained(CKPT["vad"])}
    return ours, theirs


def _clips(lengths, seed=3) -> list:
    """Two synthesized voices over each other, cut to `lengths` samples."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        a = synth_utterance("".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                                    for _ in range(6)), rng)[0]
        b = voice_b(synth_utterance("天地人日月水", rng)[0])
        mix = np.zeros(n, np.float32)
        mix[: min(n, len(a))] += a[:n]
        mix[n // 4: n // 4 + min(n - n // 4, len(b))] += 0.7 * b[: n - n // 4]
        out.append(mix)
    return out


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _same_segments(got, want, tol=0.01):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert abs(g[0] - w[0]) <= tol and abs(g[1] - w[1]) <= tol, (got, want)


def _same_scores(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        lsb = np.abs(g["streams"].astype(np.float64) - w["streams"]) * 32768
        assert g["streams"].shape == w["streams"].shape and lsb.max() <= 1.0, lsb.max()
        assert _cos(g["embs"], w["embs"]).min() >= 0.9999
        for gv, wv in zip(g["vads"], w["vads"]):
            _same_segments(gv, wv)


@pytest.mark.parametrize("lengths", [(9000,), (7000, 12000, 20000)])
def test_separate_score_matches_jax(engines, lengths):
    """One clip (the 32000 rung, batch 1) and three clips (batch 4, a
    padded row), Apollo in the same pass."""
    ours, theirs = engines
    clips = _clips(lengths)
    got = tfused.FusedSeparation(ours["sep"], ours["spk"], ours["vad"], ours["rest"]) \
        .separate_score(clips)
    with jax.default_matmul_precision("highest"):
        want = jfused.FusedSeparation(theirs["sep"], theirs["spk"], theirs["vad"],
                                      theirs["rest"]).separate_score(clips)
    _same_scores(got, want)


def test_separate_score_without_vad_or_restorer(engines):
    ours, theirs = engines
    clips = _clips((8000,))
    got = tfused.FusedSeparation(ours["sep"], ours["spk"]).separate_score(clips)
    with jax.default_matmul_precision("highest"):
        want = jfused.FusedSeparation(theirs["sep"], theirs["spk"]).separate_score(clips)
    _same_scores(got, want)
    assert got[0]["vads"] == [[[0.0, 0.5]]] * 2


@pytest.mark.parametrize("lengths", [(8000,) * 5, (160001,), (8000, 0)])
def test_separate_score_gives_none_like_jax(engines, lengths):
    """More than four clips, a clip above the top rung or an empty clip:
    None, the windowed path's signal."""
    ours, theirs = engines
    clips = [np.zeros(n, np.float32) for n in lengths]
    assert tfused.FusedSeparation(ours["sep"], ours["spk"]).separate_score(clips) is None
    assert jfused.FusedSeparation(theirs["sep"], theirs["spk"]).separate_score(clips) is None


def _target_asrs(engines):
    ours, theirs = engines
    ap = AudioProcessor(**F32)
    ap.separator, ap.restorer = ours["sep"], ours["rest"]
    asrp = ASRProcessor(**F32)
    asrp.vad = ours["vad"]
    jap, jasrp = JaxAudioProcessor(), JaxASRProcessor()
    jap.separator, jap.restorer, jasrp.vad = theirs["sep"], theirs["rest"], theirs["vad"]
    return (TargetASR(ap, asrp, speaker_engine=ours["spk"], **F32),
            JaxTargetASR(jap, jasrp, speaker_engine=theirs["spk"]))


@pytest.mark.parametrize("n_clips", [2, 5])
def test_multi_speakers_separate_batch_matches_jax(engines, n_clips):
    """Two clips take the fused pass (restored in it); five take the
    separator's batch, one embedding pass, one VAD pass and the restorer
    per stream."""
    ours, theirs = _target_asrs(engines)
    clips = _clips((9000, 11000, 6000, 7000, 8000)[:n_clips], seed=5)
    target = ours.spk.get_speaker_embedding(clips[0][:4000])
    got = ours.multi_speakers_separate_batch(clips, target)
    with jax.default_matmul_precision("highest"):
        want = theirs.multi_speakers_separate_batch(clips, target)
    assert len(got) == len(want) == n_clips
    for g_entries, w_entries in zip(got, want):
        assert len(g_entries) == len(w_entries)
        for g, w in zip(g_entries, w_entries):
            assert set(g) == set(w) == {"timerange", "text", "score", "sampling_rate", "audio"}
            assert g["score"] == w["score"] and g["text"] == w["text"] == ""
            _same_segments([g["timerange"]], [w["timerange"]])
            lsb = np.abs(g["audio"].astype(np.float64) - w["audio"]) * 32768
            assert g["audio"].shape == w["audio"].shape and lsb.max() <= 1.0, lsb.max()


@pytest.fixture(scope="module")
def asr_engines():
    ours = ASREngine.from_pretrained(CKPT["asr"], **F32), \
        PunctuationEngine.from_pretrained(CKPT["punc"], **F32)
    theirs = JaxASREngine.from_pretrained(CKPT["asr"]), \
        JaxPuncEngine.from_pretrained(CKPT["punc"])
    return ours, theirs


def test_fused_asr_matches_jax(asr_engines):
    """Three speakers' interval masks of one 4 s int16 buffer (the 64000
    rung, as `analyze` leaves it): the same texts, timestamps and classes."""
    (asr, punc), (jasr, jpunc) = asr_engines
    rng = np.random.default_rng(11)
    audio = np.zeros(64000, np.float32)
    pos = 1600
    for text in ("天地人日月", "一二三四", "水火山石"):
        utt = synth_utterance(text, rng)[0]
        audio[pos: pos + len(utt)] = utt
        pos += len(utt) + 800
    i16 = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    ranges = [[(0.05, 1.4), (2.5, 3.2)], [(1.3, 2.6)], [(3.0, 3.9)]]
    ours = tfused.FusedASR(asr, punc)
    theirs = jfused.FusedASR(jasr, jpunc)
    assert ours.punc is not None and theirs.punc is not None
    got = ours.transcribe_masked(torch.from_numpy(i16), 62000, ranges)
    with jax.default_matmul_precision("highest"):
        want = theirs.transcribe_masked(jnp.asarray(i16), 62000, ranges)
    assert got == want
    assert any(r["text"] for r in got) and all(len(r["punc_cls"]) == len(r["text"]) for r in got)
