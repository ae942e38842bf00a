"""Streaming blocked top-K MIPS, in plain PyTorch (the Hopper kernel of
the same scan is `repro_torch.kernels.mips_topk`).

Scans the catalog in blocks of `block_items`, carrying a running [B, K]
top-K: each block is scored with one matmul and merged with the carry
by `merge_topk`. O(P L) flops like the dense path, but O(B (K + block))
memory instead of O(B P). The reference pads the catalog to a whole
number of blocks with dead rows; here the last block is simply shorter,
which selects the same items.
"""
from __future__ import annotations

import torch

from repro_torch.constants import NEG_INF
from repro_torch.mips.exact import TopK, merge_topk

__all__ = ["topk_streaming"]


def topk_streaming(
    queries: torch.Tensor, items: torch.Tensor, k: int, block_items: int = 4096
) -> TopK:
    """queries [B, L], items [P, L] -> TopK([B, K])."""
    b = queries.shape[0]
    p = items.shape[0]
    dev = queries.device
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for lo in range(0, p, block_items):
        blk = items[lo:lo + block_items]
        s = (queries @ blk.T).float()  # [B, block]
        ids = torch.arange(lo, lo + blk.shape[0], dtype=torch.int32, device=dev)
        merged = merge_topk(
            torch.cat([best_s, s], dim=1),
            torch.cat([best_i, ids.expand(b, -1)], dim=1),
            k,
        )
        best_s, best_i = merged
    return TopK(scores=best_s, indices=best_i)
