"""Polyphase resampling: on the device as one frames x filterbank product,
and on the host with scipy.

Counterpart of targetdiarization_tpu/ops/resample.py. With a Kaiser
lowpass h of length 2·half+1 (scipy.signal.resample_poly's default),
resample_poly's output is y[b·up + p] = Σ_q x[b·down + q] · W[q, p] with
W[qi, p] = h[half + p·down − (q_min + qi)·up]: frame x at hop `down` and
multiply by the dense (Q, up) filterbank made once on the host. The JAX
package runs that product at full float32 precision, so `resample` runs it
in float32 with TF32 off.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..runtime.precision import exact_float32
from .stft import frame_signal
from .tables import device_table


def _rates(target_sr: int, source_sr: int) -> tuple[int, int]:
    g = math.gcd(int(target_sr), int(source_sr))
    return int(target_sr) // g, int(source_sr) // g


@lru_cache(maxsize=64)
def _design_filter(up: int, down: int) -> np.ndarray:
    """Kaiser lowpass identical to scipy.signal.resample_poly's default."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    h = firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float32)


@lru_cache(maxsize=64)
def _filterbank(up: int, down: int) -> tuple[np.ndarray, int]:
    """(W, q_min): the dense (Q, up) polyphase filterbank,
    W[qi, p] = h[half + p·down − (q_min+qi)·up]."""
    h = _design_filter(up, down)
    half = (len(h) - 1) // 2
    q_min = -(half // up)
    q_max = (half + (up - 1) * down) // up
    q = np.arange(q_min, q_max + 1)
    p = np.arange(up)
    idx = half + p[None, :] * down - q[:, None] * up
    valid = (idx >= 0) & (idx < len(h))
    w = np.where(valid, h[np.clip(idx, 0, len(h) - 1)], 0.0)
    return w.astype(np.float32), q_min


def _bank(up: int, down: int) -> np.ndarray:
    return _filterbank(up, down)[0]


def _resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    w_np, q_min = _filterbank(up, down)
    q_len = w_np.shape[0]
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    n_blocks = -(-n_out // up)
    need = (n_blocks - 1) * down + q_len
    pad_r = max(0, need - (n_in - q_min))
    xp = torch.nn.functional.pad(x.float(), (-q_min, pad_r))
    frames = frame_signal(xp, q_len, down)[..., :n_blocks, :]  # (..., n_blocks, Q)
    with exact_float32():
        y = torch.matmul(frames, device_table(_bank, (up, down), x.device))  # (..., n_blocks, up)
    return y.reshape(*x.shape[:-1], -1)[..., :n_out]


def resample(audio: torch.Tensor, target_sr: int, source_sr: int) -> torch.Tensor:
    """Resample (T,) or (C, T) audio between sample rates on its device."""
    if target_sr == source_sr:
        return audio
    up, down = _rates(target_sr, source_sr)
    return _resample_poly(audio, up, down)


def resample_poly_np(audio: np.ndarray, target_sr: int, source_sr: int) -> np.ndarray:
    """Resample 1-D or (C, T) float audio along its last axis on the host."""
    if target_sr == source_sr:
        return np.asarray(audio)
    from scipy.signal import resample_poly

    up, down = _rates(target_sr, source_sr)
    return resample_poly(np.asarray(audio), up, down, axis=-1).astype(np.float32)
