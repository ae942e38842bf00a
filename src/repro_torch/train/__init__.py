"""The training driver of the port (single device) and its checkpoints."""
from repro_torch.train.checkpoint import (
    CheckpointCorruptError,
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.trainer import FOPOTrainer, TrainerConfig

__all__ = [
    "CheckpointCorruptError",
    "FOPOTrainer",
    "TrainerConfig",
    "latest_checkpoint",
    "list_checkpoints",
    "restore_checkpoint",
    "save_checkpoint",
]
