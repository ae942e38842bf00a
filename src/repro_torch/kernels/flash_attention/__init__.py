"""Flash attention, forward and backward: hand-written Hopper kernels
(`csrc/flash_attention_{fwd,bwd}.cu`), their plain PyTorch versions
(`ref.py`) and the dispatching wrappers (`ops.py`)."""
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_fwd",
    "flash_attention_ref",
]
