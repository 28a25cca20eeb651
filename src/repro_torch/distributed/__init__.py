"""Checkpoints and the multi-rank layer of the port: ``checkpoint``
(synchronous and background writes, mesh-agnostic pipeline restores),
``sharding`` (process meshes, the node-partitioned layout, the masked
state sync, the logical-axis rules), ``compression`` and
``DataParallelTrainer``."""

from repro_torch.distributed import checkpoint, compression
from repro_torch.distributed.dp_trainer import DataParallelTrainer
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    Rules,
    get_mesh,
    get_rules,
    logical_spec,
    set_sharding_context,
    shard,
    sharding_context,
)

__all__ = [
    "DEFAULT_RULES",
    "DataParallelTrainer",
    "Rules",
    "checkpoint",
    "compression",
    "get_mesh",
    "get_rules",
    "logical_spec",
    "set_sharding_context",
    "shard",
    "sharding_context",
]
