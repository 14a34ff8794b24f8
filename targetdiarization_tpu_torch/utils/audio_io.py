"""Host-side WAV reading and writing.

The port's copy of the PCM WAV branch of targetdiarization_tpu/utils/
audio_io.py: 8-, 16-, 24- and 32-bit integer PCM from a path, bytes or a
binary file object (`io.BytesIO`), as float32 in [-1, 1], (T,) for mono
and (C, T) for several channels. Compressed formats and URLs are not
read here.
"""

from __future__ import annotations

import io

import numpy as np


def _pcm_to_float32(raw: bytes, sampwidth: int, nchannels: int) -> np.ndarray:
    """Interleaved PCM bytes -> float32 in [-1, 1], (C, T) for C > 1."""
    if sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) \
            | (b[:, 2].astype(np.int32) << 16)
        i = np.where(i >= 1 << 23, i - (1 << 24), i)
        x = i.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported PCM sample width: {sampwidth}")
    if nchannels > 1:
        x = x.reshape(-1, nchannels).T
    return x


def read_wav(source) -> tuple[np.ndarray, int]:
    """(audio, sample rate) of a PCM WAV given as a path, bytes, an
    `io.BytesIO` (all of its buffer) or another binary file object (from
    its current position)."""
    import wave

    if isinstance(source, io.BytesIO):  # the whole buffer, wherever its position
        source = source.getvalue()
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(source)
    with wave.open(source if hasattr(source, "read") else str(source), "rb") as w:
        sr, nch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    return _pcm_to_float32(raw, width, nch), sr


def read_audio(source, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """`read_wav`, resampled on the host to `sample_rate` when it is given."""
    audio, sr = read_wav(source)
    if sample_rate is not None and sample_rate != sr:
        from ..ops.resample import resample_poly_np

        audio, sr = resample_poly_np(audio, sample_rate, sr), sample_rate
    return audio, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Mono float audio in [-1, 1] as 16-bit PCM WAV (clipped, rounded)."""
    import wave

    pcm = np.clip(np.round(np.asarray(audio, np.float32).ravel() * 32767.0), -32768, 32767)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.astype("<i2").tobytes())
