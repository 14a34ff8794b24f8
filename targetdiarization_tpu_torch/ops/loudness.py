"""ITU-R BS.1770-4 gated integrated loudness (LUFS) on the host.

Counterpart of targetdiarization_tpu/utils/native.py::
integrated_loudness_native (native/tdaudio.cpp) and ops/loudness.py:
the K-weighting prefilter as two float64 biquads (high shelf, then the
RLB high-pass), 400 ms blocks at 75 % overlap, an absolute gate at
-70 LKFS and a relative gate 10 LU under the absolute-gated mean.
"""

from __future__ import annotations

import numpy as np


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
