"""PyTorch and CUDA port of targetdiarization_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module layout (`runtime/`, `ops/`,
`models/`, `processors/`) so each piece has an obvious counterpart. It
imports torch, numpy and scipy only. The Pallas kernels of the JAX
package become CUDA C++ kernels under `csrc/`, built with `nvcc` at first
use and bound with ctypes (`ops/kernels/_build.py`).

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where each kernel wrapper runs its plain PyTorch version.
"""

# The public entry points, importable from the package root and loaded on
# first access, as the JAX package exports them.
_API = {
    "TargetDiarization": "targetdiarization_tpu_torch.pipeline.offline",
    "TargetDiarizationStream": "targetdiarization_tpu_torch.pipeline.streaming",
    "TargetASR": "targetdiarization_tpu_torch.pipeline.target_asr",
    "AudioProcessor": "targetdiarization_tpu_torch.processors.audio",
    "ASRProcessor": "targetdiarization_tpu_torch.processors.asr",
}


def __getattr__(name):
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
