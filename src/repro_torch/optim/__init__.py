"""Optimizers of the port (the reference's `repro.optim.optimizers`) and
int8 gradient compression (`repro.optim.compression`)."""
from repro_torch.optim.compression import (
    compressed_all_reduce,
    dequantize_int8,
    error_feedback_compress,
    quantize_int8,
)
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
    "compressed_all_reduce",
    "constant_schedule",
    "cosine_schedule",
    "dequantize_int8",
    "error_feedback_compress",
    "quantize_int8",
    "sgd",
]
