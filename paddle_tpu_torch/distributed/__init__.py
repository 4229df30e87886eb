"""The port's distributed layer: process-level contracts and the
crash-consistent checkpoint (:mod:`.checkpoint`,
:mod:`.checkpoint_manager`), whose directories both packages read."""
from .checkpoint import (CheckpointCorruptError, HostLocalShard,
                         ReshardError, is_committed, load_sharded,
                         load_state, read_leaf, save_sharded, save_state,
                         verify_checkpoint)
from .checkpoint_manager import CheckpointManager, latest_checkpoint

__all__ = ["CheckpointCorruptError", "HostLocalShard", "ReshardError",
           "is_committed", "load_sharded", "load_state", "read_leaf",
           "save_sharded", "save_state", "verify_checkpoint",
           "CheckpointManager", "latest_checkpoint"]
