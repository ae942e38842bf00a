"""EmbeddingBag (padded multi-hot gather-sum): a hand-written Hopper
kernel (`csrc/embedding_bag.cu`), its plain PyTorch version (`ref.py`)
and the dispatching wrapper (`ops.py`)."""
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref"]
