"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All of `csrc/*.cu` compile in one `nvcc` call into one shared library with
a plain `extern "C"` interface (no PyTorch headers, so a build takes
seconds). The library lands in `_build/` inside the package, named by a
hash of the sources and flags, and is built at first use. Each wrapper
declares its C function's ctypes argument types with `declare`, which
records them in SIGNATURES (the tests hold them against the sources).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


def build(path: str) -> None:
    """Compile every csrc/*.cu into `path` in one nvcc call."""
    cu, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if the sources changed."""
    path = library_path()
    if not os.path.exists(path):
        build(path)
    return ctypes.CDLL(path)


SIGNATURES: dict[str, list] = {}


def declare(symbol: str, argtypes: list):
    """Records `symbol`'s ctypes argument types (the C function returns a
    cudaError_t as int); returns a function that binds it at first call."""
    SIGNATURES[symbol] = argtypes

    @functools.cache
    def bound():
        fn = getattr(load_library(), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    return bound
