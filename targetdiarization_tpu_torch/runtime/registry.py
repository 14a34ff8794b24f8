"""Checkpoint-driven model construction.

Counterpart of targetdiarization_tpu/runtime/registry.py::from_pretrained:
the checkpoint's own `model_name` picks the class. The ported models are
MossFormer2, Paraformer, CTTransformerPunc, FsmnVADNet, TDFUNet,
SegmentationNet, ERes2NetV2, CAMPlusPlus, Apollo, FlowEnhancer, EmotionNet,
SenseVoice, WhisperStyleASR and the ten separators of `models/zoo.py`;
any other name raises. `save_checkpoint` writes MossFormer2, FsmnVADNet,
Apollo, Paraformer, SenseVoice or a zoo model the way the JAX package does.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .convert import CONVERTERS, INVERSE_CONVERTERS
from .params import load_checkpoint


def get_model_cls(name: str):
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

    models = {"MossFormer2": MossFormer2, "Paraformer": Paraformer,
              "CTTransformerPunc": CTTransformerPunc, "FsmnVADNet": FsmnVADNet,
              "TDFUNet": TDFUNet, "SegmentationNet": SegmentationNet, "ERes2NetV2": ERes2NetV2,
              "Apollo": Apollo, "FlowEnhancer": FlowEnhancer, "EmotionNet": EmotionNet,
              "CAMPlusPlus": CAMPlusPlus, "SenseVoice": SenseVoice,
              "WhisperStyleASR": WhisperStyleASR, **CLASSES}
    if name not in models:
        raise KeyError(f"model {name!r} is not ported; ported: {sorted(models)}")
    return models[name]


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
    flat `params.npz` in the JAX names and layouts (`INVERSE_CONVERTERS`)
    and `model.json`. MossFormer2, FsmnVADNet, Apollo, Paraformer, SenseVoice
    and the zoo's classes have an inverse."""
    flat = INVERSE_CONVERTERS[model_name](model.state_dict())
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **flat)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"model_name": model_name, "model_args": dict(model_args or {})}, f)
