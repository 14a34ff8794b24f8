"""Bucket ladders: pad variable-length audio to a fixed menu of lengths.

Counterpart of targetdiarization_tpu/runtime/buckets.py. Each engine pads
its input to the smallest rung that holds it and carries the true length,
so masked ops ignore the padding exactly. The helpers take numpy arrays or
torch tensors and return the same kind.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

# Audio-seconds ladder shared by embedding/VAD stages: 1..30 s @16 kHz.
DEFAULT_AUDIO_LADDER = (1, 2, 4, 8, 16, 30)


@dataclass(frozen=True)
class BucketLadder:
    """A sorted menu of allowed lengths (in samples or frames)."""

    rungs: tuple = field(default_factory=tuple)

    @classmethod
    def from_seconds(cls, seconds=DEFAULT_AUDIO_LADDER, sr: int = 16000) -> "BucketLadder":
        return cls(tuple(int(s * sr) for s in seconds))

    def bucket(self, n: int) -> int:
        """Smallest rung >= n; the top rung if n exceeds the ladder."""
        i = bisect.bisect_left(self.rungs, n)
        return self.rungs[min(i, len(self.rungs) - 1)]

    def split_plan(self, n: int) -> list:
        """Lengths covering n: repeated top rungs plus one bucketed tail."""
        top = self.rungs[-1]
        plan = [top] * (n // top)
        rem = n - top * (n // top)
        if rem or not plan:
            plan.append(self.bucket(max(rem, 1)))
        return plan


def pad_to(x, n: int, axis: int = -1, value: float = 0.0):
    """Pad `x` (numpy array or tensor) along `axis` to length n with
    `value` (no-op if already n)."""
    cur = x.shape[axis]
    if cur == n:
        return x
    if cur > n:
        raise ValueError(f"length {cur} exceeds bucket {n}")
    axis = axis if axis >= 0 else x.ndim + axis
    if isinstance(x, torch.Tensor):
        return F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [0, n - cur], value=value)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - cur)
    return np.pad(x, pad, constant_values=value)


def pad_to_bucket(x, ladder: BucketLadder, axis: int = -1):
    """Pad to the ladder's rung; returns (padded, original_length)."""
    n = x.shape[axis]
    return pad_to(x, ladder.bucket(n), axis=axis), n


def length_mask(lengths, max_len: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) {0, 1} validity mask (a tensor, on the
    lengths' device when they are one)."""
    lengths = torch.as_tensor(lengths)
    if lengths.ndim == 0:
        lengths = lengths[None]
    return (torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)


def masked_mean(x, mask, axis, eps: float = 1e-9):
    """Mean of x over `axis` counting only mask == 1 positions (mask
    broadcasts against x); the denominator is the mask's sum, so padded
    positions change nothing."""
    if isinstance(x, torch.Tensor):
        return (x * mask).sum(dim=axis) / torch.clamp(mask.sum(dim=axis), min=eps)
    return np.sum(x * mask, axis=axis) / np.maximum(np.sum(mask, axis=axis), eps)
