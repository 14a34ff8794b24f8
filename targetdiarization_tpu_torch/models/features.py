"""Acoustic front end of the FunASR-family models: fbank, LFR, CMVN.

Counterpart of targetdiarization_tpu/models/features.py. All of it runs
in float32; the engines cast the result to their compute type.
"""

from __future__ import annotations

import torch

from ..ops.mel import log_mel_spectrogram

FRAME_HOP_S = 0.01
FRAME_LEN_S = 0.025


def num_frames(n_samples: int, sr: int = 16000) -> int:
    """Frames of snip-edges framing (as `frame_signal` makes them)."""
    frame, hop = int(FRAME_LEN_S * sr), int(FRAME_HOP_S * sr)
    return 0 if n_samples < frame else 1 + (n_samples - frame) // hop


def fbank(audio: torch.Tensor, sr: int = 16000, n_mels: int = 80) -> torch.Tensor:
    """(..., T) float in [-1, 1] -> (..., frames, n_mels) log-mel, scaled to
    int16 range first as Kaldi expects."""
    return log_mel_spectrogram(audio.float() * 32768.0, sr=sr, n_mels=n_mels,
                               frame_length=int(FRAME_LEN_S * sr),
                               hop=int(FRAME_HOP_S * sr))


def lfr(x: torch.Tensor, m: int = 7, n: int = 6) -> torch.Tensor:
    """Low frame rate: (..., T, D) -> (..., ceil(T/n), m*D), stacking m
    frames every n. The left edge repeats frame 0 (m-1)//2 times, the
    right edge repeats the last frame until every window is full."""
    t, d = x.shape[-2], x.shape[-1]
    left = (m - 1) // 2
    t_out = -(-t // n)
    pad_right = max((t_out - 1) * n + m - left - t, 0)
    xp = torch.cat([x[..., :1, :].expand(*x.shape[:-2], left, d), x,
                    x[..., -1:, :].expand(*x.shape[:-2], pad_right, d)], dim=-2)
    idx = (torch.arange(m, device=x.device)[None, :]
           + n * torch.arange(t_out, device=x.device)[:, None])
    return xp[..., idx, :].reshape(*x.shape[:-2], t_out, m * d)


def apply_cmvn(x: torch.Tensor, mean: torch.Tensor, istd: torch.Tensor) -> torch.Tensor:
    """(x + mean) * istd: FunASR stores negative means and inverse stddevs."""
    return (x + mean) * istd
