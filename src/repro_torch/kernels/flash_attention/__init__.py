"""Flash attention forward: a hand-written Hopper kernel
(`csrc/flash_attention_fwd.cu`), its plain PyTorch version (`ref.py`) and
the dispatching wrapper (`ops.py`)."""
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref"]
