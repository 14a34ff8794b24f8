"""flax parameter trees -> the port's `state_dict`s.

The JAX package's parameters come as nested dicts of numpy arrays
(`runtime/params.py::load_checkpoint`, or a flax `init` moved to numpy).
MossFormer2 trees come in two layouts: the shipped checkpoints' per-layer
`mask_net/flash_{i}`, `mask_net/fsmn_{i}`, and the stacked
`mask_net/layers/{flash,fsmn}` with a leading layer axis that the JAX
model's `nn.scan` uses. Both convert to the same state dict.

Layout rules:
- Dense kernel (in, out) -> Linear weight (out, in);
- encoder Conv kernel (K, 1, N) -> conv1d weight (N, 1, K);
- decoder ConvTranspose kernel (K, N, 1) -> flipped along K, then
  (N, 1, K) for conv_transpose1d (flax's transposed conv does not flip
  the kernel, PyTorch's does);
- LayerNorm scale -> weight;
- depthwise kernels keep the JAX layout (K, m, C).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": leaf}} -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_STACKED = re.compile(r"^(.*?)layers/(flash|fsmn)/(.+)$")


def _unstack_layers(flat: dict) -> dict:
    """.../layers/{flash,fsmn}/... (L, ...) -> .../{flash,fsmn}_{i}/..."""
    out = {}
    for key, v in flat.items():
        m = _STACKED.fullmatch(key)
        if m is None:
            out[key] = v
            continue
        prefix, kind, rest = m.groups()
        for i in range(v.shape[0]):
            out[f"{prefix}{kind}_{i}/{rest}"] = v[i]
    return out


_RENAMES = (
    (re.compile(r"(^|/)(flash|fsmn)_(\d+)/"), r"\1layers/\3/\2/"),
    (re.compile(r"(^|/)dwconv/kernel$"), r"\1dwk"),
    (re.compile(r"(^|/)ddn/conv(\d+)/kernel$"), r"\1ddn/conv_kernels/\2"),
    (re.compile(r"(^|/)ddn/(in_w|in_b|prelu)(\d+)$"), r"\1ddn/\2/\3"),
    (re.compile(r"(^|/)scale$"), r"\1weight"),
)


def mossformer2_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.separation.MossFormer2` from a flax tree
    ({"params": ...} or bare), in either layer layout. The rules hold for
    any subtree too (a FlashBlock's, a GatedFsmnBlock's, ...)."""
    flat = _unstack_layers(flatten(tree.get("params", tree)))
    sd = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        if key == "encoder/kernel":
            sd["encoder.weight"] = v.transpose(2, 1, 0)
            continue
        if key == "decoder/kernel":
            sd["decoder.weight"] = v[::-1].transpose(1, 2, 0)
            continue
        name = key
        for pat, rep in _RENAMES:
            name = pat.sub(rep, name)
        if name.endswith("/kernel"):  # Dense
            name = name[: -len("kernel")] + "weight"
            v = v.T
        sd[name.replace("/", ".")] = v
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


CONVERTERS = {"MossFormer2": mossformer2_state_dict}
