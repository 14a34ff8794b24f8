"""`TargetDiarization.infer` of the port against the JAX package's, end to
end on the shipped checkpoints (`den-`, `vad-`, `seg-`, `spk-`, `rest-`,
`asr-`, `punc-bootstrap` and the 256/12 `sep-bootstrap`, the separator the
server builds on the CPU), in float32 on the CPU, with an enrollment
of the second voice (4 s). Inputs are synthesized two-voice dialogues
(`chip_smoke.dialogue`, numpy seeds), cut to CPU-friendly lengths:
- (a) 2.5 s with overlapped turns: segmentation, re-clustering, the
  target's overlap clips through `FusedSeparation` with Apollo in the same
  pass, the batched ASR and punctuation;
- (b) 4 s in turns in the single-speaker mode: `FusedASR` on the analysed
  device buffer (the bootstrap segmentation model marks two channels on
  any speech, so with a target only this mode skips separation).
(c), the cluster diarizer, is in `test_torch_offline_cluster.py`.

Limits, and why:
- target_spk, the speakers, the entries' speakers and types equal;
- timeranges within one frame (10 ms);
- texts equal where no clip went through the separator; where one did,
  its streams agree within 1 LSB of int16 (`test_torch_fused_separation.py`),
  which can flip an argmax of the bootstrap Paraformer anywhere in that
  speaker's combined track, so the texts over all entries may differ in
  one character in 33 (a character error rate of 0.03), and in one
  character where they are shorter (`chip_smoke.py` holds the card's
  float32 kernels against float32 plain to CER 0.03);
- the target audio of equal length and at least 30 dB SI-SDR apart.
"""

import os
from unittest import mock

import jax
import pytest
import torch

from chip_smoke import cer, dialogue, enrollment, si_sdr, strip_punct
from targetdiarization_tpu.models.diarization import SegmentationEngine as JaxSegmentationEngine
from targetdiarization_tpu.pipeline.offline import TargetDiarization as JaxTargetDiarization
from targetdiarization_tpu.pipeline.target_asr import TargetASR as JaxTargetASR
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu_torch.models.diarization import SegmentationEngine
from targetdiarization_tpu_torch.pipeline.offline import TargetDiarization
from targetdiarization_tpu_torch.pipeline.target_asr import TargetASR
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.processors.audio import AudioProcessor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ckpt(name: str) -> str:
    return os.path.join(REPO, "checkpoints", name)


def build_both(dtype: str = "float32", **td_kw):
    """The port's and the JAX package's systems as the server builds them,
    every engine computing in `dtype` (the JAX engines read it from
    TD_COMPUTE_DTYPE as they are made)."""
    kw = {"device": "cpu", "compute_dtype": dtype}
    ours = TargetDiarization(
        TargetASR(AudioProcessor(ckpt("sep-bootstrap"), denoise_model=ckpt("den-bootstrap"),
                                 restoration_model=ckpt("rest-bootstrap"), **kw),
                  ASRProcessor(vad_model=ckpt("vad-bootstrap"), asr_model=ckpt("asr-bootstrap"),
                               punc_model=ckpt("punc-bootstrap"), **kw),
                  embedding_model=ckpt("spk-bootstrap"), **kw),
        segmentation_engine=SegmentationEngine.from_pretrained(ckpt("seg-bootstrap"), **kw),
        **td_kw)
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": dtype}):
        theirs = JaxTargetDiarization(
            JaxTargetASR(JaxAudioProcessor(denoise_model=ckpt("den-bootstrap"),
                                           separation_model=ckpt("sep-bootstrap"),
                                           restoration_model=ckpt("rest-bootstrap")),
                         JaxASRProcessor(vad_model=ckpt("vad-bootstrap"),
                                         asr_model=ckpt("asr-bootstrap"),
                                         punc_model=ckpt("punc-bootstrap")),
                         embedding_model=ckpt("spk-bootstrap")),
            segmentation_engine=JaxSegmentationEngine.from_pretrained(ckpt("seg-bootstrap")),
            **td_kw)
    return ours, theirs


def run_both(systems, audio, target, **kw):
    ours, theirs = systems
    got = ours.infer(audio, target, **kw)
    with jax.default_matmul_precision("highest"):
        want = theirs.infer(audio, target, **kw)
    return got, want


def same_infer(got, want, separated: bool):
    g_spk, g_res, g_audio = got
    w_spk, w_res, w_audio = want
    assert g_spk == w_spk
    assert sorted({r["speaker"] for r in g_res}) == sorted({r["speaker"] for r in w_res})
    assert len(g_res) == len(w_res) and len(g_res) > 0, (g_res, w_res)
    for g, w in zip(g_res, w_res):
        assert set(g) == set(w) == {"speaker", "timerange", "text", "type", "score"}
        assert (g["speaker"], g["type"], g["score"]) == (w["speaker"], w["type"], w["score"])
        assert max(abs(a - b) for a, b in zip(g["timerange"], w["timerange"])) <= 0.01
        if not separated:
            assert g["text"] == w["text"], (g, w)
    if separated:
        text_g = "".join(strip_punct(r["text"]) for r in g_res)
        text_w = "".join(strip_punct(r["text"]) for r in w_res)
        edits = round(cer(text_w, text_g) * len(text_w)) if text_w else len(text_g)
        assert edits <= max(1, 0.03 * len(text_w)), (g_res, w_res)
    assert (g_audio is None) == (w_audio is None)
    if g_audio is not None:
        assert g_audio.shape == w_audio.shape
        if w_audio.any():
            assert si_sdr(g_audio, w_audio) >= 30.0
        else:  # no target (the single-speaker mode): silence
            assert not g_audio.any()


@pytest.fixture(scope="module")
def systems():
    return build_both()


@pytest.fixture(scope="module")
def target():
    return enrollment(4.0, seed=9)


def test_infer_overlapped_dialogue_matches_jax(systems, target):
    got, want = run_both(systems, dialogue(2.5, seed=1, overlap=True), target)
    assert any(r["type"] == "overlap" for r in want[1])  # the separator ran
    same_infer(got, want, separated=True)


def test_infer_single_speaker_mode_goes_through_fused_asr(systems, target, monkeypatch):
    calls = []
    ours = systems[0]
    transcribe = ours.fused_asr.transcribe_masked
    monkeypatch.setattr(ours.fused_asr, "transcribe_masked",
                        lambda *a: calls.append(a) or transcribe(*a))
    got, want = run_both(systems, dialogue(4.0, seed=2, overlap=False), target, is_single=True)
    assert len(calls) == 1
    same_infer(got, want, separated=False)
    assert got[1][0]["text"]
