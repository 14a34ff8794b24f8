"""Host-side polyphase resampling.

Counterpart of targetdiarization_tpu/ops/resample.py::resample_poly_np:
`scipy.signal.resample_poly` with the same up/down factors.
"""

from __future__ import annotations

import math

import numpy as np


def _rates(target_sr: int, source_sr: int) -> tuple[int, int]:
    g = math.gcd(int(target_sr), int(source_sr))
    return int(target_sr) // g, int(source_sr) // g


def resample_poly_np(audio: np.ndarray, target_sr: int, source_sr: int) -> np.ndarray:
    """Resample 1-D or (C, T) float audio along its last axis."""
    if target_sr == source_sr:
        return np.asarray(audio)
    from scipy.signal import resample_poly

    up, down = _rates(target_sr, source_sr)
    return resample_poly(np.asarray(audio), up, down, axis=-1).astype(np.float32)
