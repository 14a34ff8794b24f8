"""Runtime layer: shape discipline, parameter store, model registry, config,
and the readers of reference checkpoints (`port_rules`, `onnx_io`).

Counterpart of targetdiarization_tpu/runtime/__init__.py, with the same
public names. `fast_init`, `save_checkpoint_orbax` and
`upgrade_scan_layout` have no counterpart: nothing is traced, orbax is not
installed, and `convert.py` takes both layer layouts.
"""

from .buckets import (  # noqa: F401
    DEFAULT_AUDIO_LADDER,
    BucketLadder,
    length_mask,
    masked_mean,
    pad_to,
    pad_to_bucket,
)
from .config import FrameworkConfig, env_config  # noqa: F401
from .params import load_checkpoint, param_count, tree_cast  # noqa: F401
from .registry import (  # noqa: F401
    from_pretrained,
    get_model_cls,
    list_models,
    register_model,
    save_checkpoint,
)
