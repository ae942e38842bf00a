"""Exact streamed top-K MIPS: a hand-written Hopper kernel
(`csrc/mips_topk.cu`), its plain PyTorch version (`ref.py`) and the
dispatching wrapper (`ops.py`)."""
from repro_torch.kernels.mips_topk.ops import mips_topk

__all__ = ["mips_topk"]
