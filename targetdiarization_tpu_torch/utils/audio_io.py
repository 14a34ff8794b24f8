"""Host-side WAV reading and writing.

The port's copy of the PCM WAV branch of targetdiarization_tpu/utils/
audio_io.py: 8-, 16-, 24- and 32-bit integer PCM from a path, bytes or a
binary file object (`io.BytesIO`), as float32 in [-1, 1], (T,) for mono
and (C, T) for several channels; and its writers: 16-bit PCM WAV as the
JAX package writes it, other formats through ffmpeg where it is on the
PATH, and the int16 byte converters of the WebSocket protocol.
Compressed formats are not read here, and URLs are fetched by
`AudioProcessor.download_audio`.
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess

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


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Float audio in [-1, 1], (T,) or (C, T), as 16-bit PCM WAV: scaled by
    32768, clipped to the int16 range and truncated toward zero, the
    channels of a (C, T) input interleaved (the JAX package's writer)."""
    import wave

    audio = np.asarray(audio)
    nch = audio.shape[0] if audio.ndim == 2 else 1
    interleaved = audio.T if audio.ndim == 2 else audio
    pcm = np.clip(interleaved * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(os.fspath(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())


def write_audio(path, audio: np.ndarray, sample_rate: int) -> None:
    """`write_wav` for a .wav path, or where no ffmpeg is on the PATH;
    another extension is written as WAV to a temporary file beside `path`
    and converted by ffmpeg."""
    path = os.fspath(path)
    ffmpeg = shutil.which("ffmpeg")
    if path.lower().endswith(".wav") or ffmpeg is None:
        write_wav(path, audio, sample_rate)
        return
    tmp = path + ".tmp.wav"
    write_wav(tmp, audio, sample_rate)
    try:
        subprocess.run([ffmpeg, "-y", "-i", tmp, path], capture_output=True, check=True)
    finally:
        os.unlink(tmp)


def float32_to_int16_bytes(audio: np.ndarray) -> bytes:
    """Float audio in [-1, 1] -> little-endian int16 bytes (x32768, clipped,
    truncated), in the array's order."""
    return np.clip(np.asarray(audio) * 32768.0, -32768, 32767).astype("<i2").tobytes()


def int16_bytes_to_float32(raw: bytes) -> np.ndarray:
    """Little-endian int16 bytes -> float32 in [-1, 1]."""
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
