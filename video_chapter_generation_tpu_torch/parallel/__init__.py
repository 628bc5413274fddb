"""The device mesh of one process and host-level collectives across
processes (counterpart of the JAX package's parallel/)."""

from .dist import (
    all_gather_object,
    barrier,
    broadcast_object,
    initialize,
    is_primary,
    process_count,
    process_index,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    local_batch_size,
    local_devices,
    make_mesh,
    replicated,
    shard_batch,
    shard_params_tp,
    shard_params_zero,
    use_mesh,
)

__all__ = [
    "all_gather_object",
    "barrier",
    "broadcast_object",
    "initialize",
    "is_primary",
    "process_count",
    "process_index",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "local_batch_size",
    "local_devices",
    "make_mesh",
    "replicated",
    "shard_batch",
    "shard_params_tp",
    "shard_params_zero",
    "use_mesh",
]
