"""Mel filterbank and Kaldi-style log-mel fbank.

Counterpart of targetdiarization_tpu/ops/mel.py. The filterbank matrix
is built once with numpy in float64 and stored as float32, as in the JAX
package; the fbank runs in float32 whatever the caller's compute type.
Conventions (the FunASR front end): snip-edges framing, per-frame DC
removal, pre-emphasis 0.97 with the first sample against itself, Povey
window, FFT length the next power of two (512 for 400), HTK mel from
20 Hz, log of energies floored at float32 epsilon.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .stft import frame_signal
from .tables import device_table

LOG_FLOOR = 1.1920928955078125e-07


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=16)
def _mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular HTK filterbank, float32."""
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    lower, center, upper = hz_pts[:-2], hz_pts[1:-1], hz_pts[2:]
    up = (fft_freqs[None, :] - lower[:, None]) / np.maximum(center - lower, 1e-8)[:, None]
    down = (upper[:, None] - fft_freqs[None, :]) / np.maximum(upper - center, 1e-8)[:, None]
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    return _mel_matrix(sr, n_fft, n_mels, float(fmin), float(fmax or sr / 2.0))


def _povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def _povey_window_f32(n: int) -> np.ndarray:
    return _povey_window(n).astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, sr: int = 16000, n_mels: int = 80,
                        frame_length: int = 400, hop: int = 160,
                        preemph: float = 0.97) -> torch.Tensor:
    """(..., T) int16-range float -> (..., n_frames, n_mels) log-mel, float32."""
    audio = audio.float()
    n_fft = 1 << (frame_length - 1).bit_length()
    frames = frame_signal(audio, frame_length, hop)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = frames - preemph * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    win = device_table(_povey_window_f32, (frame_length,), audio.device)
    spec = torch.fft.rfft(pre * win, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = device_table(mel_filterbank, (sr, n_fft, n_mels, 20.0), audio.device)
    mel = torch.matmul(power, fb.T)
    return torch.log(torch.clamp_min(mel, LOG_FLOOR))
