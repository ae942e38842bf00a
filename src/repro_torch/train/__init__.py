"""The training driver of the port (single device)."""
from repro_torch.train.trainer import FOPOTrainer, TrainerConfig

__all__ = ["FOPOTrainer", "TrainerConfig"]
