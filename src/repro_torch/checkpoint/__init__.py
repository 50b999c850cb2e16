"""Checkpoints: the JAX package's on-disk format, an async manager, the facility's storage tiers."""

from repro_torch.checkpoint.manager import CheckpointManager, SaveRecord
from repro_torch.checkpoint.storage import QOS_TIER, TIERS, DataMover, StorageTier
from repro_torch.checkpoint.tensorstore_lite import (
    available_steps,
    checkpoint_bytes,
    delete_step,
    restore_pytree,
    save_pytree,
)

__all__ = [
    "CheckpointManager",
    "SaveRecord",
    "QOS_TIER",
    "TIERS",
    "DataMover",
    "StorageTier",
    "available_steps",
    "checkpoint_bytes",
    "delete_step",
    "restore_pytree",
    "save_pytree",
]
