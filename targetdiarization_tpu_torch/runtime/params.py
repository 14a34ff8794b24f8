"""Checkpoint reader: `model.json` sidecar plus a flat `params.npz`.

Counterpart of targetdiarization_tpu/runtime/params.py::load_checkpoint.
A checkpoint directory holds {"model_name", "model_args", ...} in
`model.json` and the parameter tree in `params.npz`, flattened with "/"
joined keys (`params/mask_net/flash_0/to_qk/proj/kernel`). Leaves are
returned as float32 numpy arrays whatever the stored type: a checkpoint
stored in float16 is widened on load and never computed in float16.
"""

from __future__ import annotations

import json
import os

import numpy as np

_SIDECAR = "model.json"
_NPZ = "params.npz"


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Returns (nested parameter tree of float32 arrays, meta dict)."""
    sidecar = os.path.join(path, _SIDECAR)
    npz_path = os.path.join(path, _NPZ)
    if not os.path.exists(sidecar) or not os.path.exists(npz_path):
        raise FileNotFoundError(f"no {_SIDECAR} + {_NPZ} checkpoint under {path!r}")
    with open(sidecar) as f:
        meta = json.load(f)
    flat = {}
    with np.load(npz_path) as z:
        for k in z.files:
            a = z[k]
            flat[k] = a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a
    return unflatten(flat), meta
