"""ITU-R BS.1770-4 gated integrated loudness (LUFS), on the host and on
the device.

Host: `integrated_loudness`, the plain numpy version of the host
library's meter (utils/native.py::integrated_loudness_native, which the
callers run): the K-weighting prefilter as two float64 biquads (high
shelf, then the RLB high-pass), 400 ms blocks at 75 % overlap, an absolute
gate at -70 LKFS and a relative gate 10 LU under the absolute-gated mean.

Device: counterpart of targetdiarization_tpu/ops/loudness.py. `k_weight`
is one rfft, times the filters' exact response (float64 on the host, cast
to complex64), then irfft, over n_fft = 2^ceil(log2(T + 8192)) so that the
IIR tail does not wrap; `integrated_loudness_device` and
`normalize_loudness` gate with masks, in float32. `biquad_scan` is the
JAX package's public biquad (an associative scan there), here a plain
sequential recurrence; no path calls it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .stft import frame_signal
from .tables import device_table


def _k_weighting(sr: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """((b, a) shelf, (b, a) high-pass) of the K-filter at `sr`."""
    f0, gain, q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    k = np.tan(np.pi * f0 / sr)
    vh = 10.0 ** (gain / 20.0)
    vb = vh ** 0.499666774155
    a0 = 1.0 + k / q + k * k
    shelf = (np.array([(vh + vb * k / q + k * k) / a0,
                       2.0 * (k * k - vh) / a0,
                       (vh - vb * k / q + k * k) / a0]),
             np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]))
    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    high_pass = (np.array([1.0, -2.0, 1.0]),
                 np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]))
    return shelf, high_pass


def _lufs(z: float) -> float:
    return -0.691 + 10.0 * np.log10(max(z, 1e-30))


def integrated_loudness(audio: np.ndarray, sr: int) -> float:
    """Gated integrated loudness of mono audio; -inf when every block is
    gated out."""
    from scipy.signal import lfilter

    x = np.asarray(audio, np.float32).ravel().astype(np.float64)
    n = x.size
    if n == 0:
        return float("-inf")
    y = x
    for b, a in _k_weighting(sr):
        y = lfilter(b, a, y)
    t_g = int(0.4 * sr)
    if n < t_g:  # too short to gate: full-signal power
        z = float(np.mean(y * y))
        return -0.691 + 10.0 * np.log10(max(z, 1e-12))
    hop = t_g // 4
    n_blocks = 1 + (n - t_g) // hop
    cum = np.concatenate([[0.0], np.cumsum(y * y)])
    starts = np.arange(n_blocks) * hop
    z = (cum[starts + t_g] - cum[starts]) / t_g
    lev = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))
    above_abs = lev > -70.0
    if not above_abs.any():
        return float("-inf")
    gamma_r = _lufs(float(z[above_abs].mean())) - 10.0
    above_rel = above_abs & (lev > gamma_r)
    if not above_rel.any():
        return float("-inf")
    return float(_lufs(float(z[above_rel].mean())))


# ---------------- device ----------------


@lru_cache(maxsize=8)
def _k_weighting_sos(sr: int) -> np.ndarray:
    """The two biquads [b0 b1 b2 a0 a1 a2] of the K-filter, float64."""
    return np.stack([np.concatenate([b, a]) for b, a in _k_weighting(sr)]).astype(np.float64)


def biquad_scan(x: torch.Tensor, b, a) -> torch.Tensor:
    """One biquad (direct form I) over (T,) audio, in float32:
    y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]."""
    b0, b1, b2 = (float(v) for v in b[:3])
    a1, a2 = np.float32(a[1]), np.float32(a[2])
    x = x.float()
    xm1 = torch.cat([x.new_zeros(1), x[:-1]])
    xm2 = torch.cat([x.new_zeros(2), x[:-2]])
    u = (b0 * x + b1 * xm1 + b2 * xm2).cpu().numpy()  # the feed-forward part
    y = np.zeros_like(u)
    y1 = y2 = np.float32(0.0)
    for n in range(u.shape[0]):
        y1, y2 = u[n] - a1 * y1 - a2 * y2, y1
        y[n] = y1
    return torch.from_numpy(y).to(x.device)


@lru_cache(maxsize=32)
def _k_freq_response(sr: int, n_fft: int) -> np.ndarray:
    """Exact response of the two K-filter biquads at the rfft bins of an
    n_fft transform, computed in float64, stored as complex64."""
    w = 2.0 * np.pi * np.arange(n_fft // 2 + 1) / n_fft
    z = np.exp(-1j * w)
    h = np.ones_like(z)
    for b0, b1, b2, a0, a1, a2 in _k_weighting_sos(sr):
        h *= (b0 + b1 * z + b2 * z * z) / (a0 + a1 * z + a2 * z * z)
    return h.astype(np.complex64)


_K_PAD = 8192  # covers the K-filter's impulse-response tail (38 Hz high-pass poles)


def k_weight(audio: torch.Tensor, sr: int = 16000) -> torch.Tensor:
    """The BS.1770 K-weighting prefilter on (..., T) audio, float32."""
    t = audio.shape[-1]
    n_fft = 1 << max(int(np.ceil(np.log2(t + _K_PAD))), 8)
    h = device_table(_k_freq_response, (sr, n_fft), audio.device)
    spec = torch.fft.rfft(audio.float(), n=n_fft)
    return torch.fft.irfft(spec * h, n=n_fft)[..., :t].float()


def lufs(z: torch.Tensor) -> torch.Tensor:
    """Mean square -> LUFS, floored at 1e-30."""
    return -0.691 + 10.0 * torch.log10(torch.clamp_min(z, 1e-30))


def integrated_loudness_device(audio: torch.Tensor, sr: int = 16000) -> torch.Tensor:
    """Gated integrated loudness (LUFS) of (T,) or (C, T) audio, as a 0-d
    float32 tensor on the audio's device; -inf when every block is gated
    out."""
    x = audio if audio.dim() > 1 else audio[None]
    y = k_weight(x, sr)
    t_g = int(0.4 * sr)
    hop = t_g // 4
    if y.shape[-1] < t_g:  # too short to gate: the whole signal's power
        z = y.square().mean(dim=-1).sum()
        return -0.691 + 10.0 * torch.log10(torch.clamp_min(z, 1e-12))
    z_blocks = frame_signal(y, t_g, hop).square().mean(dim=-1).sum(dim=0)
    l_blocks = lufs(z_blocks)
    abs_mask = l_blocks > -70.0
    z_abs = (z_blocks * abs_mask).sum() / torch.clamp_min(abs_mask.sum(), 1.0)
    rel_mask = abs_mask & (l_blocks > lufs(z_abs) - 10.0)
    z_rel = (z_blocks * rel_mask).sum() / torch.clamp_min(rel_mask.sum(), 1.0)
    return torch.where(rel_mask.sum() > 0, lufs(z_rel), torch.full_like(z_rel, -np.inf))


def normalize_loudness(audio: torch.Tensor, sr: int = 16000,
                       target_lufs: float = -23.0) -> torch.Tensor:
    """Scale audio to the target integrated loudness; unchanged where the
    gain is not finite (silence)."""
    gain = torch.pow(10.0, (target_lufs - integrated_loudness_device(audio, sr)) / 20.0)
    gain = torch.where(torch.isfinite(gain), gain, torch.ones_like(gain))
    return audio * gain
