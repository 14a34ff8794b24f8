"""Compute-type policy for inference engines.

Counterpart of targetdiarization_tpu/runtime/precision.py: bfloat16 on the
card, float32 on the CPU, overridable with `TD_COMPUTE_DTYPE` or an
engine's `compute_dtype=` argument. Engines return float32 whatever they
computed in.
"""

from __future__ import annotations

import os

import torch

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
