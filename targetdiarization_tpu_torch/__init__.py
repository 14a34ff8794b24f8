"""PyTorch and CUDA port of targetdiarization_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module layout (`runtime/`, `ops/`,
`models/`, `processors/`) so each piece has an obvious counterpart. It
imports torch, numpy and scipy only. The Pallas kernels of the JAX
package become CUDA C++ kernels under `csrc/`, built with `nvcc` at first
use and bound with ctypes (`ops/kernels/_build.py`).

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where each kernel wrapper runs its plain PyTorch version.
"""
