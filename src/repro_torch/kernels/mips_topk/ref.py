"""The plain PyTorch version of the exact top-K MIPS kernel.

Same function as `mips_topk_cuda`: the exact top-K of queries @ items.T,
sorted descending, taken as the reference's Pallas kernel takes it: the
catalog streamed in blocks, each block's scores merged into a running
top-K, so the [B, P] score matrix is never stored. The CPU path and the
tests use it; on the card it is only the yardstick the kernel is held
to. It counts its calls in ``mips_topk_ref.calls``.
"""
from __future__ import annotations

import torch

from repro_torch.mips.streaming import topk_streaming

__all__ = ["BLOCK_ITEMS", "mips_topk_ref"]

BLOCK_ITEMS = 65536  # catalog rows per block of the streamed scan


def mips_topk_ref(
    queries: torch.Tensor,  # [B, L] float32
    items: torch.Tensor,  # [P, L] float32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32)."""
    mips_topk_ref.calls += 1
    top = topk_streaming(queries, items, k, block_items=BLOCK_ITEMS)
    return top.scores, top.indices


mips_topk_ref.calls = 0
