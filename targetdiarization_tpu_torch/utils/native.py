"""ctypes binding of the port's host runtime (csrc/host/tdaudio.cpp).

Counterpart of targetdiarization_tpu/utils/native.py, with its names:

    pcm16_to_f32 / f32_to_pcm16      WS-protocol PCM marshalling
    integrated_loudness_native       BS.1770-4 gated LUFS on the host (the
                                     streaming gate runs it once a 1 s chunk)
    resample_linear                  quick host-rate conversion
    RingBuffer                       SPSC float ring for stream ingest

The library is built at first use with the host compiler (g++ -O3 -shared
-fPIC -std=c++17 -ffp-contract=off, so that no multiply-add is fused and the
numpy versions give the same bits on any host) into the package's `_build/`,
named by a hash of the source and the flags, under the kernel build's lock,
apart from the CUDA library. A build or load failure raises with the
compiler's message. TD_DISABLE_NATIVE=1, read at each call, asks for the
numpy versions instead: `pcm16_to_f32_plain`, `f32_to_pcm16_plain`,
`resample_linear_plain`, `RingBufferPlain`, and for the meter
`ops/loudness.py::integrated_loudness`. Each gives the library's result
(the meter to float64 rounding: scipy's filter form sums in another
order). Unlike the JAX package's numpy fallback, which truncates,
`f32_to_pcm16_plain` rounds to nearest as the C++ does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..ops.kernels import _build

SOURCE = os.path.join(_build.CSRC, "host", "tdaudio.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LIBRARY: list = []


def disabled() -> bool:
    """Whether TD_DISABLE_NATIVE=1 asks for the numpy versions."""
    return os.environ.get("TD_DISABLE_NATIVE") == "1"


def library_path() -> str:
    """Where the library for the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"libtdaudio_{h.hexdigest()[:16]}.so")


def build(path: str) -> None:
    """Compile SOURCE into `path` with g++ (a temporary file renamed into
    place, so that processes building at once each see a whole library)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cannot build the host library: no g++ on the PATH")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p, i16p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16)
    size, handle = ctypes.c_size_t, ctypes.c_void_p
    for name, args, res in (
            ("pcm16_to_f32", [i16p, f32p, size], None),
            ("f32_to_pcm16", [f32p, i16p, size], None),
            ("integrated_loudness", [f32p, size, ctypes.c_int], ctypes.c_double),
            ("resample_linear", [f32p, size, f32p, size], None),
            ("ring_create", [size], handle),
            ("ring_free", [handle], None),
            ("ring_push", [handle, f32p, size], size),
            ("ring_pop", [handle, f32p, size], size),
            ("ring_size", [handle], size),
            ("ring_space", [handle], size)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load_library() -> ctypes.CDLL:
    """The host library, built first if the source changed."""
    if _LIBRARY:
        return _LIBRARY[0]
    with _build._LOCK:
        if not _LIBRARY:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _LIBRARY.append(_declare(ctypes.CDLL(path)))
    return _LIBRARY[0]


def _lib():
    return None if disabled() else load_library()


def has_native() -> bool:
    """True when the calls run the library; False when TD_DISABLE_NATIVE=1.
    Raises where the library can neither be built nor loaded."""
    return _lib() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


# ---------------- PCM ----------------


def pcm16_to_f32_plain(pcm: np.ndarray) -> np.ndarray:
    return np.asarray(pcm, np.int16).astype(np.float32) / np.float32(32768.0)


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1), in pcm's shape."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lib = _lib()
    if lib is None:
        return pcm16_to_f32_plain(pcm)
    out = np.empty(pcm.size, np.float32)
    lib.pcm16_to_f32(_i16p(pcm), _f32p(out), pcm.size)
    return out.reshape(pcm.shape)


def f32_to_pcm16_plain(audio: np.ndarray) -> np.ndarray:
    v = np.clip(np.asarray(audio, np.float32) * np.float32(32768.0), -32768.0, 32767.0)
    return np.rint(v).astype(np.int16)


def f32_to_pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 -> int16 PCM: x 32768, clipped, rounded to nearest (ties to
    even), in audio's shape."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    lib = _lib()
    if lib is None:
        return f32_to_pcm16_plain(audio)
    out = np.empty(audio.size, np.int16)
    lib.f32_to_pcm16(_f32p(audio), _i16p(out), audio.size)
    return out.reshape(audio.shape)


# ---------------- loudness ----------------


def integrated_loudness_native(audio: np.ndarray, sr: int) -> float:
    """Gated integrated loudness (LUFS) of mono audio; -inf when every
    400 ms block is gated out; below one block, the whole signal's power
    (floored at -120.691). The callers return early there."""
    audio = np.ascontiguousarray(audio, dtype=np.float32).ravel()
    lib = _lib()
    if lib is None:
        from ..ops.loudness import integrated_loudness

        return integrated_loudness(audio, sr)
    return float(lib.integrated_loudness(_f32p(audio), audio.size, int(sr)))


# ---------------- resampling ----------------


def resample_linear_plain(audio: np.ndarray, n_out: int) -> np.ndarray:
    x = np.asarray(audio, np.float32).ravel().astype(np.float64)
    n_in = x.size
    if n_in == 0 or n_out == 0:
        return np.zeros(n_out, np.float32)
    if n_in == 1:
        return np.full(n_out, x[0], np.float32)
    pos = np.arange(n_out) * ((n_in - 1) / max(n_out - 1, 1))
    lo = np.minimum(pos.astype(np.int64), n_in - 2)
    frac = pos - lo
    return ((1.0 - frac) * x[lo] + frac * x[lo + 1]).astype(np.float32)


def resample_linear(audio: np.ndarray, n_out: int) -> np.ndarray:
    """(n_out,) float32: linear interpolation of audio's samples at n_out
    points from its first sample to its last (zeros for empty audio)."""
    audio = np.ascontiguousarray(audio, dtype=np.float32).ravel()
    lib = _lib()
    if lib is None:
        return resample_linear_plain(audio, n_out)
    out = np.zeros(n_out, np.float32)
    lib.resample_linear(_f32p(audio), audio.size, _f32p(out), n_out)
    return out


# ---------------- ring buffer ----------------


class RingBufferPlain:
    """The ring's numpy version: a float32 buffer of at most `capacity`
    samples; `push` takes what fits and returns the count, `pop` returns
    up to n of the oldest."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = np.zeros(0, np.float32)

    def push(self, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, dtype=np.float32).ravel()
        n = min(self.space(), x.size)
        self._buf = np.concatenate([self._buf, x[:n]])
        return n

    def pop(self, n: int) -> np.ndarray:
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __len__(self) -> int:
        return len(self._buf)

    def space(self) -> int:
        return self.capacity - len(self._buf)


class RingBuffer:
    """Single-producer single-consumer float ring of `capacity` samples on
    the library (`RingBufferPlain` under TD_DISABLE_NATIVE=1): one thread
    may push while another pops."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lib = _lib()
        if self._lib is None:
            self._plain = RingBufferPlain(capacity)
        else:
            self._h = self._lib.ring_create(capacity)

    def push(self, x: np.ndarray) -> int:
        """Appends what fits of x; returns the samples written."""
        x = np.ascontiguousarray(x, dtype=np.float32).ravel()
        if self._lib is None:
            return self._plain.push(x)
        return int(self._lib.ring_push(self._h, _f32p(x), x.size))

    def pop(self, n: int) -> np.ndarray:
        """Removes and returns up to n of the oldest samples."""
        if self._lib is None:
            return self._plain.pop(n)
        out = np.empty(n, np.float32)
        return out[: int(self._lib.ring_pop(self._h, _f32p(out), n))]

    def __len__(self) -> int:
        if self._lib is None:
            return len(self._plain)
        return int(self._lib.ring_size(self._h))

    def space(self) -> int:
        """Samples that a push would take now."""
        if self._lib is None:
            return self._plain.space()
        return int(self._lib.ring_space(self._h))

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.ring_free(self._h)
            self._h = None
