"""The port's process-wide state under threads, on the CPU.

Streaming runs a session's flushes on a worker thread, the MicroBatchers'
leaders on whichever thread comes first, and several sessions at once, so:
- `runtime/precision.py::exact_float32` must hold TF32 off inside every
  thread's block and put the process's setting back only after the last
  block closes (two threads interleaved by events, in both exit orders);
- `ops/kernels/_build.py::load_library` must build once when threads reach
  it together, and an `Entry` must bind once.
"""

import threading

import pytest
import torch

from targetdiarization_tpu_torch.ops.kernels import _build
from targetdiarization_tpu_torch.runtime.precision import exact_float32


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("first_out", ["A", "B"])
def test_exact_float32_holds_across_interleaved_threads(tf32_on, first_out):
    """A opens, B opens, one closes while the other is still inside: the
    flags stay off inside both blocks and come back on after the last."""
    a_in, b_in, first_done = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def block(name, mine, other):
        with exact_float32():
            mine.set()
            assert other.wait(10)
            seen[name, "both inside"] = _flags()
            if name != first_out:
                assert first_done.wait(10)
                seen[name, "after the other left"] = _flags()
        if name == first_out:
            first_done.set()

    threads = [threading.Thread(target=block, args=("A", a_in, b_in)),
               threading.Thread(target=block, args=("B", b_in, a_in))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert set(seen.values()) == {(False, False)}, seen
    assert len(seen) == 3
    assert _flags() == (True, True)


def test_exact_float32_nests_and_restores(tf32_on):
    with exact_float32():
        with exact_float32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(ValueError):
        with exact_float32():
            raise ValueError("inside")
    assert _flags() == (True, True)


def test_load_library_builds_once_for_threads_that_come_together(monkeypatch, tmp_path):
    builds, barrier = [], threading.Barrier(8)
    monkeypatch.setattr(_build, "_LIBRARY", [])
    monkeypatch.setattr(_build, "library_path", lambda: str(tmp_path / "lib.so"))

    def slow_build(path):
        builds.append(path)
        threading.Event().wait(0.05)  # nvcc takes seconds; the others arrive meanwhile
        (tmp_path / "lib.so").write_bytes(b"")

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    got = [None] * 8

    def worker(i):
        barrier.wait()
        got[i] = _build.load_library()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(builds) == 1
    assert got[0] is not None and all(g is got[0] for g in got)


def test_entry_binds_once_for_threads_that_come_together(monkeypatch):
    class Fn:
        pass

    class Lib:
        td_fake = Fn()

    monkeypatch.setattr(_build, "_LIBRARY", [Lib()])
    entry = _build.Entry("td_fake", [])
    binds, barrier = [], threading.Barrier(8)
    bind = entry._bind

    def counting_bind():
        binds.append(1)
        threading.Event().wait(0.02)
        return bind()

    monkeypatch.setattr(entry, "_bind", counting_bind)
    got = [None] * 8

    def worker(i):
        barrier.wait()
        got[i] = entry._fn or entry._bound()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(binds) == 1 and all(g is Lib.td_fake for g in got)
