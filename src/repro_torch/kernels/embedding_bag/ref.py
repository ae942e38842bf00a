"""The plain PyTorch version of the EmbeddingBag kernel.

Same function as `embedding_bag_cuda`, step for step: per bag, the live
rows (id >= 0) added in t order into an accumulator in the table's
dtype, so a bf16 table rounds to bf16 after every add, as the TPU
kernel's output block does; an id >= V reads row V - 1 (the clamp of the
TPU kernel's row block); a bag with no live id is 0. It is the kernel's
function, not the substrate's: `repro_torch.embeddings.embedding_bag_padded`
sums in one reduction and fills a NaN row for an id >= V. The CPU path
and the tests use it; on the card it is only the yardstick the kernel is
held to. It counts its calls in ``embedding_bag_ref.calls``.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table [V, D], indices [B, T] (-1 padded) -> out [B, D] in the
    table's dtype."""
    embedding_bag_ref.calls += 1
    v = table.shape[0]
    live = indices >= 0
    rows = torch.clamp(indices.long(), 0, v - 1)
    out = torch.zeros(
        (indices.shape[0], table.shape[1]), dtype=table.dtype, device=table.device
    )
    for t in range(indices.shape[1]):
        out = torch.where(live[:, t, None], out + table[rows[:, t]], out)
    return out


embedding_bag_ref.calls = 0
