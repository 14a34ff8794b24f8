"""Framing of a signal into overlapping windows.

Counterpart of targetdiarization_tpu/ops/stft.py::frame_signal, with
snip-edges semantics: only whole frames, the first starting at sample 0.
"""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames = 1 + (T - frame_length) // hop
    (0 frames when T < frame_length)."""
    n = x.shape[-1]
    if n < frame_length:
        return x.new_zeros(*x.shape[:-1], 0, frame_length)
    return x.unfold(-1, frame_length, hop)
