"""Compute-type policy for inference engines, and the int16 audio upload.

Counterpart of targetdiarization_tpu/runtime/precision.py: bfloat16 on the
card, float32 on the CPU, overridable with `TD_COMPUTE_DTYPE` or an
engine's `compute_dtype=` argument. Engines return float32 whatever they
computed in. The ASR and VAD engines send audio to the device as int16
and divide by 32768 there, as the JAX package does: the round trip
changes the samples, so parity depends on it.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Sequence

import numpy as np
import torch
from torch import nn

_NAMES = {"float32": torch.float32, "f32": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_compute_dtype(requested: str | None, device: torch.device | str) -> torch.dtype:
    """bf16 on cuda, fp32 elsewhere, unless `requested` or
    TD_COMPUTE_DTYPE names a type ("float32"/"f32", "bfloat16"/"bf16")."""
    name = requested or os.environ.get("TD_COMPUTE_DTYPE")
    if name:
        try:
            return _NAMES[name.lower()]
        except KeyError:
            raise ValueError(f"unsupported compute dtype {name!r}; "
                             f"one of {sorted(_NAMES)}") from None
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def promote_after(model: nn.Module, first: nn.Module | Sequence[nn.Module],
                  dtype: torch.dtype) -> nn.Module:
    """The JAX package's types in a reduced compute type: every weight is
    rounded to `dtype`, but only the module(s) `first` compute in it; the
    float32 position table added to their output promotes the stream, and
    every later layer computes in float32 from the rounded weights."""
    model.to(dtype)
    if dtype != torch.float32:
        model.float()
        for m in ([first] if isinstance(first, nn.Module) else first):
            m.to(dtype)
    return model


_TF32_LOCK = threading.Lock()
_TF32_DEPTH = 0  # blocks open in any thread
_TF32_SAVED = (False, False)


@contextlib.contextmanager
def exact_float32():
    """Float32 products and convolutions in float32, not TF32, inside the
    block (the JAX package's float32 and `Precision.HIGHEST`). The flags
    are process-wide, so the blocks of all threads count as one: the first
    to open saves the process's settings and clears TF32, the last to
    close puts them back. No thread can restore TF32 while another is
    still inside its block."""
    global _TF32_DEPTH, _TF32_SAVED
    with _TF32_LOCK:
        if _TF32_DEPTH == 0:
            _TF32_SAVED = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        _TF32_DEPTH += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_DEPTH -= 1
            if _TF32_DEPTH == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _TF32_SAVED


def quantize_i16(x) -> np.ndarray:
    """Host side: float audio in [-1, 1] -> int16; integer input is cast."""
    x = np.asarray(x)
    if x.dtype.kind == "i":
        return x.astype(np.int16)
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def dequantize_audio(audio: torch.Tensor) -> torch.Tensor:
    """Device side: int16 audio -> float32 in [-1, 1]; float passes through."""
    if audio.dtype == torch.int16:
        return audio.float() / 32768.0
    return audio
