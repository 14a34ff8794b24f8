"""Stage spans as profiler ranges.

Counterpart of targetdiarization_tpu/runtime/trace.py's `trace`, with the
same span names. `trace(name)` is a nested scope that opens a
`torch.profiler.record_function` range named `name`, so that a profile of
the card groups its kernels by pipeline stage. `HOOKS` holds callables
`hook(full_name, entering)` run at each span's start and end (nested names
join with "/"), for counters that a caller attributes to stages. The JAX
package's host-time tracer is not ported: on the card a span's host time
is not its device time, and the profiler gives both.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_LOCAL = threading.local()
HOOKS: list = []


@contextmanager
def trace(name: str):
    stack = _LOCAL.__dict__.setdefault("stack", [])
    full = "/".join(stack + [name])
    stack.append(name)
    for hook in HOOKS:
        hook(full, True)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()
        for hook in HOOKS:
            hook(full, False)
