"""Data parallelism over cards (counterpart of targetdiarization_tpu/parallel)."""

from .mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
    data_parallel_step,
    pjit_forward,
)
