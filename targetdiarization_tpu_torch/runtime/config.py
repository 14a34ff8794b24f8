"""Framework configuration: a .env file, the process environment and
constructor keywords, read once at start-up.

Counterpart of targetdiarization_tpu/runtime/config.py, with the same
field and environment names, holding only the fields that
`serve/server.py::build_model` reads. Left out: `compute_dtype` (the
engines read TD_COMPUTE_DTYPE), the fields of stages the port lacks (the
diarization and embedding-name presets) and those the JAX server never
passes on (`long_audio_threshold`, `chunk_duration`, `extra`). `device`
is "cuda" (the card) or "cpu".
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _load_dotenv(path: str = ".env") -> dict:
    """Minimal dotenv reader (python-dotenv is not in the image)."""
    values = {}
    if not os.path.exists(path):
        return values
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, _, v = line.partition("=")
            values[k.strip()] = v.strip().strip("'\"")
    return values


def _env(name, cast, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class FrameworkConfig:
    """The start-up knobs `build_model` reads, under the JAX package's field
    and env names."""

    # Infra
    verbose_log: bool = False
    device: str = "cuda"  # "cuda" | "cpu"

    # Model checkpoint dirs (empty = the stage is left out)
    vad_model: str = ""
    embedding_model: str = ""
    segmentation_model: str = ""  # overlap detection
    denoise_model: str = ""
    separation_model: str = ""
    restoration_model: str = ""
    enhancement_model: str = ""  # the flow enhancer (FlowEnhancer)
    asr_model: str = ""
    asr_engine: str = "paraformer"
    punc_model: str = ""
    emotion_model: str = ""

    # Offline pipeline thresholds
    target_similarity_threshold: float = 0.0
    pyannote_clustering_threshold: float = 0.0

    # Streaming knobs
    is_vad_buffer: bool = True
    max_buffer_duration: float = 30.0
    vad_min_silence: float = 0.3
    similarity_threshold: float = 0.4
    loudness_diff_threshold: float = 12.0
    use_asr_prompt: bool = False

    # Quality preset 1/2/3
    quality: int = 2


def env_config(dotenv_path: str = ".env") -> FrameworkConfig:
    """A FrameworkConfig from .env and the process environment; unset
    values keep the dataclass defaults."""
    file_vals = _load_dotenv(dotenv_path)
    for k, v in file_vals.items():
        os.environ.setdefault(k, v)

    cfg = FrameworkConfig()
    for f in fields(FrameworkConfig):
        default = getattr(cfg, f.name)
        setattr(cfg, f.name, _env(f.name.upper(), type(default), default))
    return cfg
