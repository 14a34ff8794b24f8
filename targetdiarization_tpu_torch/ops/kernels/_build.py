"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each of `csrc/*.cu` compiles to an object in its own `nvcc` process, all
started together, and one more `nvcc` call links them into one shared
library with a plain `extern "C"` interface (no PyTorch headers, so a build
takes seconds). The library lands in `_build/` inside the package, named by a
hash of the sources and flags, and is built at first use. Each wrapper
declares its C function's ctypes argument types with `declare`, which
records them in SIGNATURES (the tests hold them against the sources) and
returns the entry point that the wrapper calls.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc under torch's CUDA_HOME, else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: neither torch's CUDA_HOME nor PATH has it")


def _sources() -> tuple[list[str], list[str]]:
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu, headers


def library_path() -> str:
    """Where the library for the current sources lives."""
    cu, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtd_kernels_{h.hexdigest()[:16]}.so")


def _spawn(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs: list) -> list:
    """Wait for every (cmd, Popen) of `procs`; raise with the first failed
    command and its output. Returns each one's stderr."""
    results = []
    for cmd, proc in procs:
        out, err = proc.communicate(timeout=600)
        results.append((cmd, proc.returncode, out, err))
    for cmd, rc, out, err in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n{err}")
    return [err for *_, err in results]


def build(path: str) -> None:
    """Compile each csrc/*.cu to an object, the nvcc processes started
    together, then link the objects into `path`."""
    cu, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    try:
        reports = _wait([_spawn([nvcc, *compile_flags, "-c", "-o", obj, src])
                         for src, obj in zip(cu, objs)])
        _wait([_spawn([nvcc, *NVCC_FLAGS, "-o", tmp, *objs])])
        with open(ptxas_log(path), "w") as f:  # each kernel's registers, spills, shared memory
            f.write("".join(reports))
        os.replace(tmp, path)
    finally:
        for leftover in [tmp, *objs]:
            if os.path.exists(leftover):
                os.remove(leftover)


def ptxas_log(path: str) -> str:
    """Where `build` keeps ptxas's report for the library at `path`."""
    return path[:-len(".so")] + ".ptxas.txt"


_LOCK = threading.RLock()  # `Entry._bound` holds it across `load_library`
_LIBRARY: list = []


def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if the sources changed. Threads
    that come here together wait for one build: nvcc runs once in a
    process."""
    if _LIBRARY:
        return _LIBRARY[0]
    with _LOCK:
        if not _LIBRARY:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _LIBRARY.append(ctypes.CDLL(path))
    return _LIBRARY[0]


SIGNATURES: dict[str, list] = {}


class Entry:
    """One `extern "C"` kernel entry point. Called with x's card index and
    the C arguments but the last; it appends PyTorch's current stream on
    that card, enters the card's context only when it is not the current
    one, and raises on a nonzero cudaError_t. The library is loaded and
    the function bound at the first call.

    With `packed` = n the C function takes one block of n int64 values (the
    arguments, then the stream) instead: ctypes converts one pointer and
    not n values. Only dwconv, whose calls at the ASR path's shapes cost
    the host more than the card, takes it: there it takes 1.0-1.2 us off
    a call of about 8 us on an H100's host (`tools/dwconv_call_cost.py`).
    Each thread fills its own block."""

    def __init__(self, symbol: str, argtypes: list, packed: int = 0):
        self.symbol = symbol
        self.argtypes = argtypes
        self.packed = packed
        self._fn = None
        self._blocks = threading.local()

    def _bind(self):
        import torch

        fn = getattr(load_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        # the raw stream handle and the current card, without the Python
        # objects that torch.cuda.current_stream() and the device context build
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        self._stream = raw or (lambda i: torch.cuda.current_stream(i).cuda_stream)
        self._device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
        self._guard = torch.cuda.device
        self._fn = fn
        return fn

    def _call(self, fn, device_index: int, args: tuple) -> int:
        stream = self._stream(device_index)
        if not self.packed:
            return fn(*args, stream)
        blocks = self._blocks
        if not hasattr(blocks, "address"):
            blocks.block = (ctypes.c_int64 * self.packed)()
            blocks.address = ctypes.addressof(blocks.block)
        blocks.block[:] = (*args, stream)
        return fn(blocks.address)

    def _bound(self):
        with _LOCK:  # one thread binds; the others find `_fn` set
            return self._fn or self._bind()

    def __call__(self, device_index: int, *args) -> None:
        fn = self._fn or self._bound()
        if device_index == self._device():
            err = self._call(fn, device_index, args)
        else:
            with self._guard(device_index):
                err = self._call(fn, device_index, args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed with CUDA error {err}")


def declare(symbol: str, argtypes: list, packed: int = 0) -> Entry:
    """Records `symbol`'s ctypes argument types (the C function returns a
    cudaError_t as int; its last argument is the stream, or it takes one
    block of `packed` int64 values) and returns its `Entry`."""
    SIGNATURES[symbol] = argtypes
    return Entry(symbol, argtypes, packed)
