"""Bucket ladders: pad variable-length audio to a fixed menu of lengths.

Copy of targetdiarization_tpu/runtime/buckets.py::BucketLadder. The
separator pads each window to the smallest rung that holds it and carries
the true length, so masked ops ignore the padding exactly.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass(frozen=True)
class BucketLadder:
    """A sorted menu of allowed lengths (in samples or frames)."""

    rungs: tuple = field(default_factory=tuple)

    def bucket(self, n: int) -> int:
        """Smallest rung >= n; the top rung if n exceeds the ladder."""
        i = bisect.bisect_left(self.rungs, n)
        return self.rungs[min(i, len(self.rungs) - 1)]
