"""In-kernel eps-mixture sampling: a hand-written Hopper kernel
(`csrc/fused_sampler.cu`), its plain PyTorch version (`ref.py`) and the
dispatching wrapper (`ops.py`)."""
from repro_torch.kernels.fused_sampler.ops import fused_mixture_sample, seed_from

__all__ = ["fused_mixture_sample", "seed_from"]
