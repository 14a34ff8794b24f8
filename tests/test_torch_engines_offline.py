"""The alternate engines end to end: both packages' `build_model()` with
ASR_ENGINE=sensevoice and EMBEDDING_MODEL=checkpoints/campp-bootstrap, on
the CPU in float32, through `TargetDiarization.infer` (one `infer_stream`
session is in `test_torch_engines_stream.py`); and `ASRProcessor` under
every engine name.

The systems come from `test_torch_stream_systems.stream_systems` (the
shipped checkpoints, one small random separator in both packages) with
the two settings in the environment, as a user gives them. SenseVoice
gives no timestamps, so `infer` transcribes each speaker's combined track
in one batched pass and makes one entry a speaker (no `FusedASR`), and
CAM++ takes ERes2NetV2's place in the front end, the enrollment and the
stream's decisions. Inputs are synthesized dialogues of 2.5-4 s
(`chip_smoke.dialogue`) with a 4 s enrollment.

Limits are the card's float32 limits (`test_torch_offline.same_infer`):
the same target, speakers, entries and types, timeranges within 10 ms,
texts equal where no clip was separated and within CER 0.03 (one
character) where one was, the target audio at 30 dB or more.
"""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from chip_smoke import dialogue, enrollment
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.serve.server import _asr_checkpoint_name as jax_checkpoint_name
from targetdiarization_tpu_torch.models.asr import ASREngine
from targetdiarization_tpu_torch.models.speaker import CAMPlusPlus
from targetdiarization_tpu_torch.models.whisper_style import WhisperStyleEngine
from targetdiarization_tpu_torch.processors import cloud_asr
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.serve.server import _asr_checkpoint_name
from test_torch_offline import run_both, same_infer
from test_torch_stream_systems import stream_systems

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def ckpt(name: str) -> str:
    return os.path.join(REPO, "checkpoints", name)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def engine_systems():
    """Both packages' `build_model()` under ASR_ENGINE=sensevoice and
    EMBEDDING_MODEL=campp-bootstrap, with the small separator."""
    with mock.patch.dict(os.environ, {"ASR_ENGINE": "sensevoice",
                                      "EMBEDDING_MODEL": ckpt("campp-bootstrap")}):
        ours, theirs = stream_systems()
    assert ours.tasr.asrp.asr.engine == theirs.tasr.asrp.asr.engine == "sensevoice"
    assert isinstance(ours.tasr.spk.model, CAMPlusPlus)
    assert type(theirs.tasr.spk.model).__name__ == "CAMPlusPlus"
    assert ours.fused_asr is None and theirs.fused_asr is None
    return ours, theirs


@pytest.fixture(scope="module")
def systems():
    return engine_systems()


@pytest.fixture(scope="module")
def target():
    return enrollment(4.0, seed=9)


def test_infer_overlapped_dialogue_matches_jax(systems, target, monkeypatch):
    """The target's overlap clips go through the separator; with no
    timestamps every speaker's pieces join in one entry of type single."""
    ours = systems[0]
    separated = []
    separate = ours.tasr.multi_speakers_separate_batch
    monkeypatch.setattr(ours.tasr, "multi_speakers_separate_batch",
                        lambda clips, *a, **k: separated.append(len(clips))
                        or separate(clips, *a, **k))
    got, want = run_both(systems, dialogue(2.5, seed=1, overlap=True), target)
    assert separated and separated[0] > 0
    same_infer(got, want, separated=True)
    assert len({r["speaker"] for r in got[1]}) == len(got[1])
    assert all(r["type"] == "single" for r in got[1])


def test_infer_single_speaker_mode_matches_jax(systems, target):
    """The single-speaker mode: one track, one entry, SenseVoice's text."""
    got, want = run_both(systems, dialogue(4.0, seed=2, overlap=False), target, is_single=True)
    same_infer(got, want, separated=False)
    assert len(got[1]) == 1 and got[1][0]["text"]


@pytest.mark.parametrize("name", ASRProcessor.LOCAL_ENGINES + ASRProcessor.API_ENGINES)
def test_asr_processor_takes_every_engine_name(name, tmp_path):
    """Each name builds the engine the JAX processor builds from the
    checkpoint its server picks (whisper-* where it ships, else
    whisper-bootstrap; sv-bootstrap; asr-bootstrap, also for the cloud
    names), and a cloud name's asr_detection goes to its client, here
    without credentials: the JAX processor's soft failure."""
    path = ckpt(_asr_checkpoint_name(REPO, name))
    assert _asr_checkpoint_name(REPO, name) == jax_checkpoint_name(REPO, name)
    ours = ASRProcessor(asr_model=path, asr_engine=name, config_file=str(tmp_path / "none.json"),
                        device="cpu", compute_dtype="float32")
    want_cls = WhisperStyleEngine if name.startswith("whisper") else ASREngine
    assert isinstance(ours.asr, want_cls) and ours.asr_engine == name
    theirs = JaxASRProcessor(asr_model=path, asr_engine=name,
                             config_file=str(tmp_path / "none.json"))
    assert type(theirs.asr).__name__ == type(ours.asr).__name__
    assert ours.asr.engine == theirs.asr.engine
    if name in ASRProcessor.API_ENGINES:
        clip = np.zeros(SR // 2, np.float32)
        with mock.patch.object(cloud_asr, "urllib_transport", None):
            got = ours.asr_detection(clip, SR)
        assert got == theirs.asr_detection(clip, SR) == [
            {"text": "", "timestamp": [], "error": "missing credentials"}]


@pytest.mark.parametrize("name,checkpoint", [("sensevoice", "sv-bootstrap"),
                                             ("whisper_v3", "whisper-v3")])
def test_timestamp_prediction_takes_the_vad_split(name, checkpoint):
    """Neither SenseVoice nor whisper aligns: timestamp_prediction splits
    the VAD's speech over the characters, as the JAX processor does."""
    kw = dict(vad_model=ckpt("vad-bootstrap"), asr_model=ckpt(checkpoint), asr_engine=name)
    ours = ASRProcessor(**kw, device="cpu", compute_dtype="float32")
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = JaxASRProcessor(**kw)
    clip = dialogue(3.0, seed=4, overlap=False)
    for text in ("天地人日月", "ab c", "一"):
        got = ours.timestamp_prediction(clip, text)
        with jax.default_matmul_precision("highest"):
            assert got == theirs.timestamp_prediction(clip, text)
        assert len(got) == len(text)
