"""Public wrapper of the EmbeddingBag kernel (`repro/kernels/embedding_bag/
ops.py`).

The combiner decides the path, as in the reference: ``sum`` is the
kernel; ``mean`` is the kernel, then a division by the bag's live count
taken in the table's dtype and floored at 1e-9 (an empty bag stays 0);
``max`` is `repro_torch.embeddings.embedding_bag_padded`, in both
packages, because the TPU kernel computes only the sum. That is the
reference's dispatch by combiner, not a fallback on failure.

The table-gather sum is a registered operator, ``torch.ops.repro_torch.
embedding_bag`` (`kernels/_library.py`); the mean's division stays
outside it. Its body dispatches by the table's device: on the CPU the
plain PyTorch version (`ref.py`), on CUDA the hand-written kernel, or
an error. There is no fallback from the kernel to the plain version. A
meta or fake tensor reaches the fake implementation, and the op walker
costs a call by `kernel.embedding_bag_work`. No path of the port
differentiates through the kernel (nor through the reference's), so the
op has no autograd formula: the table goes in detached and the sum is a
constant, on the CPU as on the card.
"""
from __future__ import annotations

import torch

from repro_torch.embeddings.bag import embedding_bag_padded
from repro_torch.kernels import _library
from repro_torch.kernels.embedding_bag import kernel as _kernel
from repro_torch.kernels.embedding_bag import ref as _ref

__all__ = ["embedding_bag"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _body(table, indices):
    if _on_cuda(table):
        return _kernel.embedding_bag_cuda(table, indices)
    return _ref.embedding_bag_ref(table, indices)


def _fake(table, indices):
    return table.new_empty((indices.shape[0], table.shape[1]))


_op = _library.define("embedding_bag(Tensor table, Tensor indices) -> Tensor", _body, _fake)


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
    out = _op(table.detach().contiguous(), indices.to(torch.int32).contiguous())
    if combiner == "mean":
        counts = (indices >= 0).to(table.dtype).sum(dim=1, keepdim=True)
        out = out / torch.clamp(counts, min=1e-9)
    return out
