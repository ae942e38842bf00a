"""IVF top-K query: a hand-written Hopper kernel (`csrc/ivf_topk.cu`),
its plain PyTorch version (`ref.py`) and the dispatching wrapper (`ops.py`)."""
from repro_torch.kernels.ivf_topk.ops import ivf_topk, tile_align_index

__all__ = ["ivf_topk", "tile_align_index"]
