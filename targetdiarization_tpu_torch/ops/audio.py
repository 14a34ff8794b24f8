"""Elementwise audio helpers: gain, RMS, peak normalization, mixing.

Counterpart of targetdiarization_tpu/ops/audio.py, on tensors of any
device; the results keep the input's type.
"""

from __future__ import annotations

import torch

# downmix weights by channel count (ITU-R BS.775 for 5.1 and 7.1)
_DOWNMIX = {
    1: [1.0],
    2: [0.5, 0.5],
    6: [0.2929, 0.2929, 0.2071, 0.0, 0.1036, 0.1036],  # L R C LFE Ls Rs
    8: [0.2412, 0.2412, 0.1705, 0.0, 0.0853, 0.0853, 0.0882, 0.0882],
}


def to_mono(audio: torch.Tensor) -> torch.Tensor:
    """(C, T) -> (T,) with the layout's weights; (T,) passes through."""
    if audio.dim() == 1:
        return audio
    nch = audio.shape[0]
    w = _DOWNMIX.get(nch, [1.0 / nch] * nch)
    return torch.einsum("c,ct->t", torch.tensor(w, dtype=audio.dtype, device=audio.device),
                        audio)


def db_to_gain(db):
    return 10.0 ** (db / 20.0) if isinstance(db, (int, float)) else torch.pow(10.0, db / 20.0)


def gain_to_db(gain: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp_min(gain, eps))


def apply_gain_db(audio: torch.Tensor, db) -> torch.Tensor:
    return audio * db_to_gain(db)


def rms(audio: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(audio.square().mean(dim=dim, keepdim=keepdim))


def rms_db(audio: torch.Tensor) -> torch.Tensor:
    return gain_to_db(rms(audio))


def peak_normalize(audio: torch.Tensor, peak_db: float = -1.0) -> torch.Tensor:
    """Scale so that the absolute peak sits at `peak_db` dBFS."""
    peak = audio.abs().max()
    return audio * (db_to_gain(peak_db) / torch.clamp_min(peak, 1e-12))


def mix_audio(a: torch.Tensor, b: torch.Tensor, snr_db: float | None = None) -> torch.Tensor:
    """a + b; with `snr_db`, b scaled to sit that far below a by RMS."""
    if snr_db is None:
        return a + b
    return a + b * (rms(a) / torch.clamp_min(rms(b), 1e-12) * db_to_gain(-snr_db))


def crossfade_concat(a: torch.Tensor, b: torch.Tensor, fade: int) -> torch.Tensor:
    """Concatenate with a linear crossfade of `fade` samples."""
    if fade <= 0:
        return torch.cat([a, b])
    ramp = torch.linspace(0.0, 1.0, fade, dtype=a.dtype, device=a.device)
    mid = a[-fade:] * (1.0 - ramp) + b[:fade] * ramp
    return torch.cat([a[:-fade], mid, b[fade:]])


def soft_clip(audio: torch.Tensor, limit: float = 0.999) -> torch.Tensor:
    """tanh soft clipper keeping |y| < limit."""
    return limit * torch.tanh(audio / limit)


def fade_edges(audio: torch.Tensor, fade: int) -> torch.Tensor:
    """Linear fade-in and fade-out of `fade` samples."""
    if fade <= 0:
        return audio
    n = audio.shape[-1]
    idx = torch.arange(n, dtype=audio.dtype, device=audio.device)
    env = torch.clamp_max(torch.minimum(idx / fade, (n - 1 - idx) / fade), 1.0)
    return audio * env

