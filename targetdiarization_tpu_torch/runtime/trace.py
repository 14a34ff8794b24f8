"""Stage spans: host totals and profiler ranges.

Counterpart of targetdiarization_tpu/runtime/trace.py, with the same span
names. `trace(name)` is a nested scope (nested names join with "/") that
adds its host seconds and one call under the joined name to a `Tracer`
(`GLOBAL_TRACER` unless another is given; `report()` prints its table,
`reset()` clears it, `enabled()` reads TD_TRACE=1), and opens a
`torch.profiler.record_function` range named `name`, so that a profile of
the card groups its kernels by stage. On the card a span's host time is
not its device time: the spans return before the work they queued ends,
and the profiler gives both. `HOOKS` holds callables `hook(full_name,
entering)` run at each span's start and end, for counters that a caller
attributes to stages. `device_profile(log_dir)` is the profiler scope,
the counterpart of the JAX package's: a `torch.profiler.profile` of the
host, and of the card where there is one, whose Chrome trace JSON it
writes into `log_dir` on exit; the spans' ranges are in it beside the
kernels.
"""

from __future__ import annotations

import os
import socket
import tempfile
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_LOCAL = threading.local()
HOOKS: list = []


class Tracer:
    """Host seconds and calls per joined span name, safe across threads."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, dt: float):
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self, sort: bool = True) -> str:
        """A table of stage, total seconds, calls and mean ms, the largest
        total first unless `sort` is false."""
        rows = [(name, self.totals[name], self.counts[name]) for name in self.totals]
        if sort:
            rows.sort(key=lambda r: -r[1])
        lines = [f"{'stage':<32} {'total_s':>9} {'calls':>6} {'mean_ms':>9}"]
        for name, total, count in rows:
            lines.append(f"{name:<32} {total:>9.3f} {count:>6d} {total / count * 1000:>9.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {name: {"total_s": self.totals[name], "calls": self.counts[name]}
                for name in self.totals}


GLOBAL_TRACER = Tracer()


@contextmanager
def trace(name: str, tracer: Tracer | None = None):
    tracer = tracer or GLOBAL_TRACER
    stack = _LOCAL.__dict__.setdefault("stack", [])
    full = "/".join(stack + [name])
    stack.append(name)
    for hook in HOOKS:
        hook(full, True)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()
        tracer.add(full, time.perf_counter() - t0)
        for hook in HOOKS:
            hook(full, False)


def report() -> str:
    return GLOBAL_TRACER.report()


def reset():
    GLOBAL_TRACER.reset()


def enabled() -> bool:
    return os.environ.get("TD_TRACE", "0") == "1"


@contextmanager
def device_profile(log_dir: str | None = None):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where a card is available) and write its Chrome trace JSON
    into `log_dir` on exit, also where the block raised, as
    `<host>.<pid>.<ns>.pt.trace.json` (view it in Perfetto or
    chrome://tracing). Yields `log_dir`, by default `torch-trace` under the
    temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield log_dir
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
