"""Public wrapper of the EmbeddingBag kernel (`repro/kernels/embedding_bag/
ops.py`).

The combiner decides the path, as in the reference: ``sum`` is the
kernel; ``mean`` is the kernel, then a division by the bag's live count
taken in the table's dtype and floored at 1e-9 (an empty bag stays 0);
``max`` is `repro_torch.embeddings.embedding_bag_padded`, in both
packages, because the TPU kernel computes only the sum. That is the
reference's dispatch by combiner, not a fallback on failure.

For ``sum`` and ``mean`` dispatch is by the table's device: on the CPU
the plain PyTorch version (`ref.py`), on CUDA the hand-written kernel,
or an error. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.embeddings.bag import embedding_bag_padded
from repro_torch.kernels.embedding_bag import kernel as _kernel
from repro_torch.kernels.embedding_bag import ref as _ref

__all__ = ["embedding_bag"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def embedding_bag(
    table: torch.Tensor,  # [V, D] fp32 or bf16
    indices: torch.Tensor,  # [B, T] int, -1 padded
    combiner: str = "sum",
) -> torch.Tensor:
    """[B, D] in the table's dtype."""
    if combiner == "max":
        return embedding_bag_padded(table, indices, combiner="max")
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    idx = indices.to(torch.int32).contiguous()
    if _on_cuda(table):
        out = _kernel.embedding_bag_cuda(table.contiguous(), idx)
    else:
        out = _ref.embedding_bag_ref(table, idx)
    if combiner == "mean":
        counts = (indices >= 0).to(table.dtype).sum(dim=1, keepdim=True)
        out = out / torch.clamp(counts, min=1e-9)
    return out
