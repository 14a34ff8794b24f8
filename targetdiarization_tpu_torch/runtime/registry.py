"""Checkpoint-driven model construction.

Counterpart of targetdiarization_tpu/runtime/registry.py::from_pretrained:
the checkpoint's own `model_name` picks the class. The ported models are
MossFormer2, Paraformer, CTTransformerPunc, FsmnVADNet, TDFUNet,
SegmentationNet, ERes2NetV2, CAMPlusPlus, Apollo, FlowEnhancer, EmotionNet,
SenseVoice and WhisperStyleASR; any other name raises.
"""

from __future__ import annotations

import torch

from .convert import CONVERTERS
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

    models = {"MossFormer2": MossFormer2, "Paraformer": Paraformer,
              "CTTransformerPunc": CTTransformerPunc, "FsmnVADNet": FsmnVADNet,
              "TDFUNet": TDFUNet, "SegmentationNet": SegmentationNet, "ERes2NetV2": ERes2NetV2,
              "Apollo": Apollo, "FlowEnhancer": FlowEnhancer, "EmotionNet": EmotionNet,
              "CAMPlusPlus": CAMPlusPlus, "SenseVoice": SenseVoice,
              "WhisperStyleASR": WhisperStyleASR}
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
