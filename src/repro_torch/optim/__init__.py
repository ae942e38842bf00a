"""Optimizers of the port (the reference's `repro.optim.optimizers`)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    sgd,
)

__all__ = [
    "Optimizer",
    "adam",
    "adamw",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "sgd",
]
