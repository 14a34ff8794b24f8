"""Host-side audio reading and writing.

The port's copy of targetdiarization_tpu/utils/audio_io.py. Reading: 8-,
16-, 24- and 32-bit integer PCM WAV from a path, bytes or a binary file
object (`io.BytesIO`), as float32 in [-1, 1], (T,) for mono and (C, T)
for several channels; a file at a path that is not a PCM WAV (mp3, m4a,
flac, float WAV, ...) is decoded by ffmpeg, looked up on the PATH at each
call, to float32 at the rate and channel count that ffmpeg reports (the
JAX package's command line and parse). A buffer is read as PCM WAV only,
as in the JAX package. Writing: 16-bit PCM WAV as the JAX package writes
it, other formats through ffmpeg where it is on the PATH, and the int16
byte converters of the WebSocket protocol. URLs are fetched by
`AudioProcessor.download_audio` and then read from their path.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
import wave

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
    if isinstance(source, io.BytesIO):  # the whole buffer, wherever its position
        source = source.getvalue()
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(source)
    with wave.open(source if hasattr(source, "read") else str(source), "rb") as w:
        sr, nch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    return _pcm_to_float32(raw, width, nch), sr


def _read_via_ffmpeg(path: str) -> tuple[np.ndarray, int]:
    """(audio, rate) of any format ffmpeg decodes, as float32 PCM: the rate
    and the channels from the "Audio:" line of its stderr (16000 and mono
    where it names none), several channels as (C, T)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"cannot decode {path!r}: not a PCM WAV and ffmpeg is unavailable")
    proc = subprocess.run([ffmpeg, "-i", path, "-f", "f32le", "-acodec", "pcm_f32le", "-"],
                          capture_output=True, check=True)
    sr, nch = 16000, 1
    for line in proc.stderr.decode("utf-8", "ignore").splitlines():
        if "Audio:" in line:
            for tok in line.split(","):
                tok = tok.strip()
                if tok.endswith("Hz"):
                    sr = int(tok.split()[0])
                elif tok == "mono":
                    nch = 1
                elif tok == "stereo":
                    nch = 2
                elif "channels" in tok:
                    nch = int(tok.split()[0])
    x = np.frombuffer(proc.stdout, dtype="<f4").astype(np.float32)
    if nch > 1:
        x = x.reshape(-1, nch).T
    return x, sr


def read_audio(source, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """`read_wav`; a path that is not a PCM WAV goes through ffmpeg. The
    audio is resampled on the host to `sample_rate` when it is given. A
    buffer or file object that is not a PCM WAV raises ValueError."""
    try:
        audio, sr = read_wav(source)
    except (wave.Error, EOFError, struct.error) as e:
        if isinstance(source, (bytes, bytearray)) or hasattr(source, "read"):
            raise ValueError(f"not a PCM WAV buffer ({e}): compressed audio is decoded "
                             "from a path only, through ffmpeg") from e
        audio, sr = _read_via_ffmpeg(os.fspath(source))
    if sample_rate is not None and sample_rate != sr:
        from ..ops.resample import resample_poly_np

        audio, sr = resample_poly_np(audio, sample_rate, sr), sample_rate
    return audio, sr


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Float audio in [-1, 1], (T,) or (C, T), as 16-bit PCM WAV: scaled by
    32768, clipped to the int16 range and truncated toward zero, the
    channels of a (C, T) input interleaved (the JAX package's writer)."""
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
