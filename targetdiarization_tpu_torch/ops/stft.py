"""Framing, overlap-add, STFT and iSTFT with hann windows.

Counterpart of targetdiarization_tpu/ops/stft.py. `frame_signal` has
snip-edges semantics: only whole frames, the first starting at sample 0.
`stft` with `center=True` pads by reflection (numpy's rule, which also
holds for pads longer than the signal). `istft` is the JAX package's:
windowed overlap-add divided by the overlap-added squared window floored
at 1e-11, not `torch.istft`, which raises where that envelope is small.

    stft(x)  -> complex (..., n_freq, n_frames), n_freq = n_fft // 2 + 1
    istft(S) -> real (..., T)
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import device_table


def _hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic hann window (torch.hann_window's default), float32, made in
    float64 on the host and cast, as the JAX package makes it."""
    return device_table(_hann, (n,), torch.device(device or "cpu"))


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames = 1 + (T - frame_length) // hop
    (0 frames when T < frame_length)."""
    n = x.shape[-1]
    if n < frame_length:
        return x.new_zeros(*x.shape[:-1], 0, frame_length)
    return x.unfold(-1, frame_length, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Inverse of frame_signal: (..., n_frames, frame_length) -> (..., T),
    T = (n_frames - 1) * hop + frame_length; r = ceil(frame_length / hop)
    slice-adds on a hop-blocked accumulator, in the JAX package's order."""
    n_frames, frame_length = frames.shape[-2], frames.shape[-1]
    out_len = (n_frames - 1) * hop + frame_length
    r = -(-frame_length // hop)
    fr = torch.nn.functional.pad(frames, (0, r * hop - frame_length))
    fr = fr.reshape(*frames.shape[:-1], r, hop)  # (..., n_frames, r, hop)
    batch = frames.shape[:-2]
    acc = frames.new_zeros(*batch, n_frames + r - 1, hop)
    for j in range(r):
        acc[..., j: j + n_frames, :] += fr[..., :, j, :]
    return acc.reshape(*batch, -1)[..., :out_len]


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """np.pad(x, pad, mode="reflect") along the last axis, for any length."""
    n = x.shape[-1]
    idx = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(idx)]
    period = 2 * (n - 1)
    idx = idx.abs() % period
    idx = torch.where(idx >= n, period - idx, idx)
    return x[..., idx]


def _padded_window(window, n_fft: int, win_length: int, device) -> torch.Tensor:
    if window is None:
        window = hann_window(win_length, device=device)
    if win_length < n_fft:  # centre the window in n_fft, as torch does
        lp = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window, (lp, n_fft - win_length - lp))
    return window


def stft(x: torch.Tensor, n_fft: int, hop: int, win_length: int | None = None,
         window: torch.Tensor | None = None, center: bool = True) -> torch.Tensor:
    """STFT of (..., T) -> complex (..., n_freq, n_frames)."""
    win_length = win_length or n_fft
    window = _padded_window(window, n_fft, win_length, x.device)
    if center:
        x = reflect_pad(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop: int, win_length: int | None = None,
          window: torch.Tensor | None = None, center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """iSTFT of complex (..., n_freq, n_frames) -> real (..., T)."""
    win_length = win_length or n_fft
    window = _padded_window(window, n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    y = overlap_add(frames, hop)
    n_frames = spec.shape[-1]
    wsq = overlap_add((window * window).expand(n_frames, n_fft), hop)
    y = y / torch.clamp_min(wsq, 1e-11)
    if center:
        y = y[..., n_fft // 2:]
        if length is not None:
            y = y[..., :length]
        else:
            y = y[..., : y.shape[-1] - n_fft // 2]
    elif length is not None:
        y = y[..., :length]
    return y
