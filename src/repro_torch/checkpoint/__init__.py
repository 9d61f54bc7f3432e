"""Atomic, rotating checkpoints in the reference's on-disk layout
(``checkpoint/manager.py``)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    load_latest,
    load_latest_raw,
    prune_checkpoints,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "load_latest", "load_latest_raw", "prune_checkpoints",
           "save_checkpoint"]
