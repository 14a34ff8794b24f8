"""`runtime/trace.py::device_profile` on the CPU.

The port's counterpart of the JAX package's `device_profile` (a
`jax.profiler` trace into a log directory) is a `torch.profiler` scope that
writes one Chrome trace JSON into its log directory. Around a small seeded
separation (`AudioProcessor.separate_speaker` on a MossFormer2 of width 32,
its weights from a seed), the file must hold every `trace()` span that the
host `Tracer` recorded, as many times as it counted them, beside the
operators they enclose; the default directory is `torch-trace` under the
temporary directory.
"""

import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from targetdiarization_tpu_torch.runtime import trace as trace_mod
from targetdiarization_tpu_torch.runtime.trace import device_profile, trace

SEED = 1908


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def processor(tmp_path_factory):
    from targetdiarization_tpu_torch.models.separation import MossFormer2
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor
    from targetdiarization_tpu_torch.runtime.registry import save_checkpoint
    from targetdiarization_tpu_torch.train.trainer import init_params

    args = dict(dim=32, enc_channels=32, num_blocks=2, group_size=32, qk_dim=16, fsmn_inner=16)
    model = MossFormer2(**args)
    model.load_state_dict(init_params(model, seed=SEED))
    root = str(tmp_path_factory.mktemp("separator"))
    save_checkpoint(root, model, "MossFormer2", args)
    return AudioProcessor(root, device="cpu")


def events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_file_holds_the_spans_of_a_forward(processor, tmp_path):
    mix = np.random.default_rng(SEED).uniform(-0.3, 0.3, 8000).astype(np.float32)
    log_dir = str(tmp_path / "profile")
    trace_mod.reset()
    with device_profile(log_dir) as got_dir:
        out = processor.separate_speaker(mix)
    assert got_dir == log_dir
    assert len(out) == 2 and all(np.isfinite(o).all() and o.shape == mix.shape for o in out)
    files = glob.glob(os.path.join(log_dir, "*"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    # the Tracer joins nested names; each range carries its span's own name
    own = {"audio/separate_speaker": "audio/separate_speaker",
           "audio/separate_speaker/audio/separate_dispatch": "audio/separate_dispatch"}
    spans = trace_mod.GLOBAL_TRACER.as_dict()
    assert set(spans) == set(own)
    evs = events(files[0])
    annotated = [e["name"] for e in evs if e.get("cat") == "user_annotation"]
    assert sorted(annotated) == sorted(own[full] for full, row in spans.items()
                                       for _ in range(row["calls"]))
    ops = {e["name"] for e in evs if e.get("cat") == "cpu_op"}
    assert any("conv1d" in op for op in ops) and any("matmul" in op or "mm" in op for op in ops)


def test_default_log_dir_is_under_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with device_profile() as log_dir:
        with trace("outer"), trace("inner"):
            torch.ones(4).sum()
    assert log_dir == os.path.join(str(tmp_path), "torch-trace")
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    annotated = [e["name"] for e in events(path) if e.get("cat") == "user_annotation"]
    assert annotated.count("outer") == annotated.count("inner") == 1


def test_each_scope_writes_its_own_file(tmp_path):
    for _ in range(2):
        with device_profile(str(tmp_path)):
            torch.zeros(2) + 1
    assert len(glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))) == 2


def test_a_block_that_raises_still_writes_its_trace(tmp_path):
    """As the JAX scope stops its trace in a `finally`."""
    with pytest.raises(ZeroDivisionError):
        with device_profile(str(tmp_path)):
            with trace("failing"):
                1 / 0
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert [e["name"] for e in events(path) if e.get("cat") == "user_annotation"] == ["failing"]
