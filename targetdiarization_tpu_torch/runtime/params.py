"""Checkpoint reader: `model.json` sidecar plus a flat `params.npz`.

Counterpart of targetdiarization_tpu/runtime/params.py::load_checkpoint,
`save_pytree` and `restore_pytree`. A checkpoint directory holds {"model_name", "model_args", ...} in
`model.json` and the parameter tree in `params.npz`, flattened with "/"
joined keys (`params/mask_net/flash_0/to_qk/proj/kernel`). Leaves are
returned as float32 numpy arrays whatever the stored type: a checkpoint
stored in float16 is widened on load and never computed in float16.

`save_pytree` / `restore_pytree` keep a trainer's state (parameters and
optimizer state: nested dicts, lists and tuples of tensors and Python numbers)
as `{name}_leaves.npz`, one array a leaf in leaf order (dicts by sorted
key), restored into a template of the same structure.

`param_count` and `tree_cast` take a module or a nested dict of tensors or
arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(item, leaves) for item in like)
    a = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
    return type(like)(a.item())  # a Python number: an optimizer's step count


def save_pytree(path: str, tree, name: str = "state") -> None:
    """Every leaf of `tree` into `{path}/{name}_leaves.npz` by leaf order
    (bfloat16 tensors as float32)."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            leaf = (t.float() if t.dtype is torch.bfloat16 else t).cpu().numpy()
        arrays[f"leaf_{i:05d}"] = np.asarray(leaf)
    np.savez(os.path.join(path, f"{name}_leaves.npz"), **arrays)


def restore_pytree(path: str, like, name: str = "state"):
    """The leaves saved by `save_pytree` in the structure of `like`, each as
    its template leaf's type (tensors on the template's device and dtype);
    raises if the counts differ."""
    with np.load(os.path.join(path, f"{name}_leaves.npz")) as z:
        leaves = [z[f"leaf_{i:05d}"] for i in range(len(z.files))]
    n = len(tree_leaves(like))
    if n != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template has {n}")
    return _rebuild(like, iter(leaves))


def param_count(params) -> int:
    """The number of parameters of a module (its `parameters()`), or of the
    leaves of a nested dict of tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(np.shape(leaf))) for leaf in tree_leaves(params))


def tree_cast(params, dtype):
    """Cast every floating leaf to `dtype`: a module's parameters and
    buffers in place (the module is returned), or a nested dict of tensors
    (torch dtype) or numpy arrays (numpy dtype) into a new dict."""
    if isinstance(params, torch.nn.Module):
        return params.to(dtype)
    if isinstance(params, dict):
        return {k: tree_cast(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.is_floating_point() else params
    a = np.asarray(params)
    return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a
