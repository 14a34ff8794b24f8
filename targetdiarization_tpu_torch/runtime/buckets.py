"""Bucket ladders: pad variable-length audio to a fixed menu of lengths.

Copy of targetdiarization_tpu/runtime/buckets.py (BucketLadder, pad_to).
Each engine pads its input to the smallest rung that holds it and carries
the true length, so masked ops ignore the padding exactly.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class BucketLadder:
    """A sorted menu of allowed lengths (in samples or frames)."""

    rungs: tuple = field(default_factory=tuple)

    def bucket(self, n: int) -> int:
        """Smallest rung >= n; the top rung if n exceeds the ladder."""
        i = bisect.bisect_left(self.rungs, n)
        return self.rungs[min(i, len(self.rungs) - 1)]


def pad_to(x: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the last axis of a numpy array to length n."""
    cur = x.shape[-1]
    if cur > n:
        raise ValueError(f"length {cur} exceeds bucket {n}")
    if cur == n:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - cur)])
