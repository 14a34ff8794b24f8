"""Checkpoint-driven model construction.

Counterpart of targetdiarization_tpu/runtime/registry.py::from_pretrained:
the checkpoint's own `model_name` picks the class. The ported models are
MossFormer2, Paraformer, CTTransformerPunc, FsmnVADNet, TDFUNet,
SegmentationNet, ERes2NetV2, CAMPlusPlus, Apollo, FlowEnhancer, EmotionNet,
SenseVoice, WhisperStyleASR and the ten separators of `models/zoo.py`,
plus any class entered with `register_model`; any other name raises.
`save_checkpoint` writes any of the ported ones, and the MOS estimators'
`DNSMOSNet` and `SigMOSNet` (`train/mos.py`), the way the JAX package does.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .convert import CONVERTERS, flat_params
from .params import load_checkpoint


_REGISTRY: dict = {}


def _table() -> dict:
    """The name -> class table, the ported classes entered on first use."""
    if "MossFormer2" not in _REGISTRY:
        from ..models.asr import Paraformer, SenseVoice
        from ..models.denoise import TDFUNet
        from ..models.diarization import SegmentationNet
        from ..models.emotion import EmotionNet
        from ..models.enhancement import FlowEnhancer
        from ..models.punctuation import CTTransformerPunc
        from ..models.restoration import Apollo
        from ..models.separation import MossFormer2
        from ..models.speaker import CAMPlusPlus, ERes2NetV2
        from ..models.vad import FsmnVADNet
        from ..models.whisper_style import WhisperStyleASR
        from ..models.zoo import CLASSES

        ported = {"MossFormer2": MossFormer2, "Paraformer": Paraformer,
                  "CTTransformerPunc": CTTransformerPunc, "FsmnVADNet": FsmnVADNet,
                  "TDFUNet": TDFUNet, "SegmentationNet": SegmentationNet,
                  "ERes2NetV2": ERes2NetV2, "Apollo": Apollo, "FlowEnhancer": FlowEnhancer,
                  "EmotionNet": EmotionNet, "CAMPlusPlus": CAMPlusPlus,
                  "SenseVoice": SenseVoice, "WhisperStyleASR": WhisperStyleASR, **CLASSES}
        for key, cls in ported.items():
            if _REGISTRY.setdefault(key, cls) is not cls:
                raise ValueError(f"duplicate model registration: {key}")
    return _REGISTRY


def register_model(cls=None, *, name: str | None = None):
    """Class decorator, `@register_model` or `@register_model(name=...)`:
    enters a class in the table `get_model_cls` and `from_pretrained` read.
    A name taken by another class raises."""

    def _register(c):
        table = _table()
        key = name or c.__name__
        if table.setdefault(key, c) is not c:
            raise ValueError(f"duplicate model registration: {key}")
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_model_cls(name: str):
    table = _table()
    if name not in table:
        raise KeyError(f"model {name!r} is not ported; ported: {sorted(table)}")
    return table[name]


def list_models() -> list:
    return sorted(_table())


def from_pretrained(path: str) -> torch.nn.Module:
    """The model stored under `path` (model.json + params.npz), with its
    weights, on the CPU in float32, in eval mode."""
    tree, meta = load_checkpoint(path)
    name = meta["model_name"]
    model = get_model_cls(name)(**meta.get("model_args", {}))
    model.load_state_dict(CONVERTERS[name](tree), strict=True)
    return model.eval()


def save_checkpoint(path: str, model: torch.nn.Module, model_name: str,
                    model_args: dict | None = None) -> None:
    """`model`'s weights under `path` as the JAX package stores them: the
    flat `params.npz` in the JAX names and layouts (`convert.flat_params`)
    and `model.json`; a BatchNorm's running statistics go under
    `batch_stats/`, as flax keeps them."""
    flat = flat_params(model_name, model)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **flat)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"model_name": model_name, "model_args": dict(model_args or {})}, f)
