"""`TargetDiarization.infer` of the port with zoo separators against the JAX
package's, and the fused path's routing of a separator it cannot take.

Both systems are built as `test_torch_offline.py` builds them (the shipped
`den-`, `vad-`, `seg-`, `spk-`, `rest-`, `asr-` and `punc-bootstrap`
checkpoints, float32 on the CPU), with the separator a checkpoint that the
JAX package wrote from a small random zoo model: ConvTasNet (pad-safe) and
TDANet (not pad-safe). The overlapped 2.5 s dialogue sends its overlap
clips through `FusedSeparation`, which both packages run padded to a rung
for any two-speaker 16 kHz separator. Limits are `test_torch_offline.py`'s
(`same_infer`).

BSRNN (4 stems at 44.1 kHz) is not such a separator: the JAX fused program
fails on its output's shape and the JAX `infer` falls back to the windowed
path; the port routes it there by `FusedSeparation.takes_separator`
without calling the model, and its overlap entries then equal the JAX
package's.
"""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from chip_smoke import dialogue, enrollment
from targetdiarization_tpu.models import zoo as jzoo
from targetdiarization_tpu.models.separation import SeparationEngine as JaxSeparationEngine
from targetdiarization_tpu.runtime.params import save_checkpoint
from targetdiarization_tpu_torch.models.separation import SeparationEngine
from test_torch_offline import build_both, run_both, same_infer
from torch_zoo_cases import TINY, seeded_params

SEPARATORS = {"ConvTasNet": TINY["ConvTasNet"], "TDANet": TINY["TDANet"],
              "BSRNN": dict(TINY["BSRNN"], sample_rate=44100, num_output=4, num_spks=4)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> a checkpoint the JAX package wrote (seeded random weights)."""
    root = tmp_path_factory.mktemp("zoo")
    out = {}
    for name, args in SEPARATORS.items():
        module = getattr(jzoo, name)(**args)
        wav = np.zeros((1, 4000), np.float32)
        params = seeded_params(module, wav, seed=2)
        out[name] = str(root / name)
        save_checkpoint(out[name], params, name, args)
    return out


@pytest.fixture(scope="module")
def systems():
    return build_both()


def use_separator(systems, path):
    """Both systems with the checkpoint under `path` as their separator."""
    ours, theirs = systems
    ours.tasr.ap.separator = SeparationEngine.from_pretrained(path, device="cpu",
                                                              compute_dtype="float32")
    ours.tasr._fused_sep = None
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs.tasr.ap.separator = JaxSeparationEngine.from_pretrained(path)
    theirs.tasr._fused_sep = None


@pytest.mark.parametrize("name", ["ConvTasNet", "TDANet"])
def test_infer_with_zoo_separator_matches_jax(systems, checkpoints, name):
    use_separator(systems, checkpoints[name])
    calls = []
    model = systems[0].tasr.ap.separator.model
    handle = model.register_forward_hook(lambda m, a, o: calls.append(tuple(a[0].shape)))
    try:
        got, want = run_both(systems, dialogue(2.5, seed=1, overlap=True),
                             enrollment(4.0, seed=9))
    finally:
        handle.remove()
    assert any(r["type"] == "overlap" for r in want[1])
    assert calls  # the zoo separator ran, in the fused pass
    same_infer(got, want, separated=True)


def test_bsrnn_takes_the_windowed_path_as_the_jax_package_does(systems, checkpoints):
    from targetdiarization_tpu_torch.pipeline.fused import FusedSeparation

    use_separator(systems, checkpoints["BSRNN"])
    ours, theirs = systems
    clips = [dialogue(1.5, seed=3, overlap=True)]
    fused = ours.tasr._fused_separation()
    assert isinstance(fused, FusedSeparation) and not fused.takes_separator
    with mock.patch.object(ours.tasr.ap.separator, "_forward",
                           side_effect=AssertionError("the model ran")):
        assert fused.separate_score(clips) is None
    # the JAX package's fused program fails on BSRNN's four stems
    with pytest.raises(Exception):
        theirs.tasr._fused_separation().separate_score(clips)
    emb = np.asarray(ours.tasr.spk.embed_batch([clips[0]])[0])
    # threshold -1: both streams are entries whatever their similarity
    got = ours.tasr.multi_speakers_separate_batch(clips, emb, threshold=-1.0)
    with jax.default_matmul_precision("highest"):
        want = theirs.tasr.multi_speakers_separate_batch(clips, emb, threshold=-1.0)
    assert len(got) == len(want) == 1 and len(got[0]) == len(want[0]) > 0
    for g, w in zip(got[0], want[0]):
        assert g["score"] == w["score"]
        assert g["audio"].shape == w["audio"].shape
        assert np.abs(g["audio"] - w["audio"]).max() <= 1e-4 * np.abs(w["audio"]).max()
    # the windowed path's four stems, loudest first
    streams = ours.tasr.ap.separator.separate_batch(clips)[0]
    with jax.default_matmul_precision("highest"):
        ref = theirs.tasr.ap.separator.separate_batch(clips)[0]
    assert streams.shape == ref.shape == (4, len(clips[0]))
    assert np.abs(streams - ref).max() <= 1e-4 * np.abs(ref).max()
    # the other separators are taken
    for name in ("ConvTasNet", "TDANet"):
        use_separator(systems, checkpoints[name])
        assert ours.tasr._fused_separation().takes_separator
