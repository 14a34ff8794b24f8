"""The streaming slice's pieces below the session loop, against the JAX
package on the CPU: `StreamChunkAnalyzer` (one device pass per chunk
decision) and the `TargetASR` strategies a flush runs
(`single_speaker_asr`, `multi_speakers_separate_asr`) with the others
ported beside them (`target_speaker_asr`, `target_speaker_separate_asr`,
`target_speaker_duration`, `batch_target_speaker_asr`,
`mix_audio_processor`) and `ASRProcessor.asr_detection`'s keywords.

Inputs are synthesized voices from numpy seeds; the models are the shipped
`vad-`, `spk-`, `asr-`, `rest-` and `seg-bootstrap` and a small random
separator given to both packages through `runtime/convert.py`
(`test_torch_stream_systems.py`); float32,
the JAX side at full matmul precision.

Limits, and why:
- the analyzer's pass on the JAX package's fbank of the same buffers:
  speech probabilities and cosine within 1e-4 of the JAX pass; the whole
  pass (the port's own fbank) within 1e-2 and 5e-3, since the packages'
  float32 fbanks differ by up to about 4e-3 in low-energy bins
  (`test_torch_fused.py`), which moves the cosine of a 0.6-1.5 s
  segment's embeddings by up to 1.4e-3 here; one row alone against the
  same row among four within 1e-5;
- the strategies: the same entries and texts, timeranges within 10 ms,
  scores within 0.01 (they are rounded to 0.01 after a cosine that agrees
  to float32 rounding); `mix_audio_processor`'s kept audio within 1e-3 of
  its peak.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BOOT_CHARS, dialogue, enrollment, synth_utterance, voice_b
from targetdiarization_tpu.models import features as jfeat
from targetdiarization_tpu.models.speaker import SpeakerEngine as JaxSpeakerEngine
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.pipeline import fused as jfused
from targetdiarization_tpu.pipeline.target_asr import TargetASR as JaxTargetASR
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu_torch.models.speaker import SpeakerEngine
from targetdiarization_tpu_torch.models.vad import VADEngine
from targetdiarization_tpu_torch.pipeline import fused as tfused
from targetdiarization_tpu_torch.pipeline.target_asr import TargetASR
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from test_torch_stream_systems import small_separators

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {k: os.path.join(REPO, "checkpoints", f"{k}-bootstrap") for k in ("vad", "spk", "asr")}
F32 = {"device": "cpu", "compute_dtype": "float32"}
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ckpt(name):
    return os.path.join(REPO, "checkpoints", name)


def _speech(seconds: float, seed: int, second_voice: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * SR), np.float32)
    pos = int(0.1 * SR)
    while pos < len(out) - SR // 4:
        utt = synth_utterance("".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                                      for _ in range(5)), rng)[0]
        utt = voice_b(utt) if second_voice else utt
        n = min(len(utt), len(out) - pos)
        out[pos: pos + n] = utt[:n]
        pos += n + int(0.2 * SR)
    return out


# ---------------- StreamChunkAnalyzer ----------------


@pytest.fixture(scope="module")
def analyzers():
    ours = tfused.StreamChunkAnalyzer(VADEngine.from_pretrained(CKPT["vad"], **F32),
                                      SpeakerEngine.from_pretrained(CKPT["spk"], **F32))
    theirs = jfused.StreamChunkAnalyzer(JaxVADEngine.from_pretrained(CKPT["vad"]),
                                        JaxSpeakerEngine.from_pretrained(CKPT["spk"]))
    return ours, theirs


def _items():
    """(buffer, last chunk) pairs at the 4 s buffer rung and the 1 s chunk
    rung: a speaker change, one voice, 0.5 s before a chunk of the other
    voice, and a 0.6 s chunk. (R5 reads the cosine only when the buffer
    holds more than its chunk. With no frame before the chunk ERes2NetV2
    pools over nothing and the packages' float32 cosines part by 1.4e-3,
    as the 1-frame row of `test_torch_speaker.py` parts them; that case is
    left out.)"""
    a, b = _speech(3.0, 1), _speech(1.0, 2, second_voice=True)
    c = _speech(2.0, 3)
    return [(np.concatenate([a[:int(1.5 * SR)], b]), b), (c, c[SR:]),
            (np.concatenate([b[:SR // 2], c[:SR]]), c[:SR]),
            (np.concatenate([a[:SR], c[:int(0.6 * SR)]]), c[:int(0.6 * SR)])]


def _port_heads_on_jax_fbank(ours, items, key):
    bucket, cs = key
    nb = ours.ROW_LADDER.bucket(len(items))
    comb, chk = np.zeros((nb, bucket), np.float32), np.zeros((nb, cs), np.float32)
    n_comb, n_chunk = np.ones(nb, np.int64), np.ones(nb, np.int64)
    for i, (x, y) in enumerate(items):
        comb[i, :len(x)] = np.round(x * 32768.0) / 32768.0
        chk[i, :len(y)] = np.round(y * 32768.0) / 32768.0
        n_comb[i], n_chunk[i] = len(x), len(y)
    with jax.default_matmul_precision("highest"):
        fc, fk = np.array(jfeat.fbank(jnp.asarray(comb))), np.array(jfeat.fbank(jnp.asarray(chk)))
    with torch.inference_mode():
        out = ours._heads(torch.from_numpy(fc), torch.from_numpy(n_comb), torch.from_numpy(fk),
                          torch.from_numpy(n_chunk))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("rows", [1, 4])
def test_stream_chunk_analyzer_matches_jax(analyzers, rows):
    ours, theirs = analyzers
    items = _items()[:rows] if rows == 1 else _items()
    key = (tfused._LADDER.bucket(64000), 16000)
    got = ours._run_batch(key, items)
    with jax.default_matmul_precision("highest"):
        want = theirs._run_batch(key, items)
    heads = _port_heads_on_jax_fbank(ours, items, key)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["probs_comb"].shape == w["probs_comb"].shape
        assert g["probs_chunk"].shape == w["probs_chunk"].shape
        assert np.abs(g["probs_comb"] - w["probs_comb"]).max() <= 1e-2
        assert np.abs(g["probs_chunk"] - w["probs_chunk"]).max() <= 1e-2
        assert abs(g["similarity"] - w["similarity"]) <= 5e-3
        tc, tk = len(w["probs_comb"]), len(w["probs_chunk"])
        assert np.abs(heads["probs_comb"][i, :tc] - w["probs_comb"]).max() <= 1e-4
        assert np.abs(heads["probs_chunk"][i, :tk] - w["probs_chunk"]).max() <= 1e-4
        assert abs(heads["similarity"][i] - w["similarity"]) <= 1e-4
    if rows == 4:
        assert min(w["similarity"] for w in want) < max(w["similarity"] for w in want)


def test_stream_chunk_row_alone_matches_row_among_four(analyzers):
    ours, _ = analyzers
    items = _items()
    key = (tfused._LADDER.bucket(64000), 16000)
    together = ours._run_batch(key, items)
    for i, item in enumerate(items):
        alone = ours._run_batch(key, [item])[0]
        for k in ("probs_comb", "probs_chunk"):
            assert np.abs(alone[k] - together[i][k]).max() <= 1e-5
        assert abs(alone["similarity"] - together[i]["similarity"]) <= 1e-5


def test_analyze_chunk_rungs_match_jax(analyzers, monkeypatch):
    """analyze_chunk picks the JAX package's rungs: a 2.5 s chunk takes the
    4 s chunk rung, a 35 s buffer keeps its last 30 s."""
    ours, theirs = analyzers
    keys = {}
    for name, a in (("ours", ours), ("theirs", theirs)):
        monkeypatch.setattr(a, "_mb", None)
        monkeypatch.setattr(a, "_run_batch", lambda key, items, name=name: keys.setdefault(
            name, (key, [(len(x), len(y)) for x, y in items])) and [None])
        a.analyze_chunk(np.zeros(35 * SR, np.float32), np.zeros(int(2.5 * SR), np.float32))
    assert keys["ours"] == keys["theirs"] == ((480000, 64000), [(480000, 40000)])


# ---------------- TargetASR strategies ----------------


@pytest.fixture(scope="module")
def target_asrs():
    """Both packages' TargetASR on a small random separator (given to both
    through `runtime/convert.py`) and the shipped Apollo (`rest-bootstrap`;
    a random Apollo leaves no speech for the VAD), VAD, ASR and speaker
    checkpoints (no punctuation)."""
    ours_sep, theirs_sep = small_separators()
    ap = AudioProcessor(restoration_model=_ckpt("rest-bootstrap"), **F32)
    ap.separator = ours_sep
    ours = TargetASR(ap, ASRProcessor(vad_model=CKPT["vad"], asr_model=CKPT["asr"], **F32),
                     SpeakerEngine.from_pretrained(CKPT["spk"], **F32))
    jap = JaxAudioProcessor(restoration_model=_ckpt("rest-bootstrap"))
    jap.separator = theirs_sep
    theirs = JaxTargetASR(jap, JaxASRProcessor(vad_model=CKPT["vad"], asr_model=CKPT["asr"]),
                          JaxSpeakerEngine.from_pretrained(CKPT["spk"]))
    return ours, theirs


def _same_entries(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert max(abs(a - b) for a, b in zip(g["timerange"], w["timerange"])) <= 0.01
        assert g["text"] == w["text"], (g, w)
        assert abs(g["score"] - w["score"]) <= 0.01
        assert g["audio"].shape == w["audio"].shape


def test_single_speaker_asr_matches_jax(target_asrs):
    ours, theirs = target_asrs
    audio = _speech(2.5, 5)
    more = {"no_punc": True, "preprocess": ["loudness_control"]}
    got = ours.single_speaker_asr(audio, is_output_audio=True, more_args=more)
    with jax.default_matmul_precision("highest"):
        want = theirs.single_speaker_asr(audio, is_output_audio=True, more_args=more)
    _same_entries(got, want)
    assert got[0]["text"] and got[0]["score"] == 1.0
    assert np.abs(got[0]["audio"] - want[0]["audio"]).max() <= 1e-5


@pytest.mark.parametrize("target", ["embedding", "first clip"])
def test_multi_speakers_separate_asr_matches_jax(target_asrs, target):
    """Both streams of a two-voice clip, the target's first, each restored
    (Apollo) and transcribed over its VAD range; with no target, the first
    VAD clip's speaker is the target."""
    ours, theirs = target_asrs
    audio = dialogue(3.0, seed=6, overlap=True)
    emb = ours.spk.get_speaker_embedding(enrollment(3.0, seed=9)) if target == "embedding" \
        else None
    kw = {"target_embedding": emb, "threshold": -1.0, "more_args": {"no_punc": True}}
    got = ours.multi_speakers_separate_asr(audio, **kw)
    with jax.default_matmul_precision("highest"):
        want = theirs.multi_speakers_separate_asr(audio, **kw)
    assert len(want) >= 1
    _same_entries(got, want)


@pytest.mark.parametrize("mode", ["merge", "separate"])
def test_target_speaker_asr_matches_jax(target_asrs, mode):
    """VAD clips scored against the target's enrollment (the mean over a
    list of two clips), kept clips transcribed each or merged."""
    ours, theirs = target_asrs
    audio = dialogue(4.0, seed=8, overlap=False)
    targets = [enrollment(2.0, seed=9), enrollment(2.0, seed=10)]
    kw = {"threshold": -1.0, "audio_input_type": mode, "is_output_audio": True,
          "more_args": {"no_punc": True}}
    got = ours.target_speaker_asr(audio, target_audio=targets, **kw)
    with jax.default_matmul_precision("highest"):
        want = theirs.target_speaker_asr(audio, target_audio=targets, **kw)
    assert len(want) >= 1 and all(w["text"] for w in want)
    _same_entries(got, want)


def test_target_speaker_separate_and_duration_match_jax(target_asrs):
    ours, theirs = target_asrs
    audio = dialogue(3.0, seed=6, overlap=True)
    emb = ours.spk.get_speaker_embedding(enrollment(3.0, seed=9))
    calls = [("target_speaker_separate_asr", {"target_embedding": emb, "threshold": -1.0,
                                              "more_args": {"no_punc": True}}),
             ("target_speaker_duration", {"target_embedding": emb, "threshold": 0.2})]
    for name, kw in calls:
        got = getattr(ours, name)(audio, **kw)
        with jax.default_matmul_precision("highest"):
            want = getattr(theirs, name)(audio, **kw)
        if name == "target_speaker_duration":
            assert got == want and got["target_duration"] + got["others_duration"]
        else:
            assert len(want) == 1
            _same_entries(got, want)


def test_batch_target_speaker_asr_matches_jax(target_asrs):
    ours, theirs = target_asrs
    inputs = [_speech(2.0, 11), _speech(2.0, 12, second_voice=True)]
    kw = {"target_audio_list": [enrollment(2.0, seed=9)], "prompt_list": ["天", "地"],
          "threshold": -1.0}
    got = ours.batch_target_speaker_asr(inputs, **kw)
    with jax.default_matmul_precision("highest"):
        want = theirs.batch_target_speaker_asr(inputs, **kw)
    assert got == want and all(want)


@pytest.mark.parametrize("case", ["noise", "single", "multi"])
def test_mix_audio_processor_matches_jax(target_asrs, case, monkeypatch):
    """A quiet chunk is noise; with the segmentation diarizer (seg-bootstrap
    in both), one voice is single and two overlapped voices multi, whose
    kept audio is the separated stream nearer the target."""
    from targetdiarization_tpu.models.diarization import SegmentationEngine as JaxSeg
    from targetdiarization_tpu_torch.models.diarization import SegmentationEngine

    ours, theirs = target_asrs
    monkeypatch.setattr(ours.asrp, "diarizer",
                        SegmentationEngine.from_pretrained(_ckpt("seg-bootstrap"), **F32))
    monkeypatch.setattr(theirs.asrp, "diarizer", JaxSeg.from_pretrained(_ckpt("seg-bootstrap")))
    audio = {"noise": 1e-3 * _speech(1.0, 13), "single": _speech(1.5, 14),
             "multi": dialogue(4.0, seed=13, overlap=True)}[case]
    emb = ours.spk.get_speaker_embedding(enrollment(3.0, seed=9))
    got = ours.mix_audio_processor(audio, target_embedding=emb)
    with jax.default_matmul_precision("highest"):
        want = theirs.mix_audio_processor(audio, target_embedding=emb)
    assert got["type"] == want["type"] == case
    assert abs(got["score"] - want["score"]) <= 1e-3 and got["sampling_rate"] == 16000
    assert got["audio"].shape == want["audio"].shape
    assert np.abs(got["audio"] - want["audio"]).max() <= 1e-3 * max(np.abs(want["audio"]).max(),
                                                                     1e-5)


def test_asr_detection_keywords(target_asrs):
    """The local engine ignores `prompt`; a per-call cloud engine goes to
    its client, which without credentials fails soft as in the JAX
    package."""
    ours, theirs = target_asrs
    audio = _speech(1.5, 7)
    base = ours.asrp.asr_detection(audio, no_punc=True)
    assert ours.asrp.asr_detection(audio, asr_engine="paraformer", prompt="天地",
                                   no_punc=True) == base
    assert not ours.asrp.api_config and not theirs.asrp.api_config
    assert ours.asrp.asr_detection(audio, asr_engine="tencent_api") == \
        theirs.asrp.asr_detection(audio, asr_engine="tencent_api") == \
        [{"text": "", "timestamp": [], "error": "missing credentials"}]
