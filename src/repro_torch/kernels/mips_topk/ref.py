"""The plain PyTorch version of the exact top-K MIPS kernel.

Same function as `mips_topk_cuda`: the exact top-K of queries @ items.T,
sorted descending, taken as the reference's Pallas kernel takes it: the
catalog streamed in blocks, each block's scores merged into a running
top-K, so the [B, P] score matrix is never stored. The CPU path and the
tests use it; on the card it is only the yardstick the kernel is held
to. It counts its calls in ``mips_topk_ref.calls``.

`mips_topk_mma` emulates the kernel's tensor-core arithmetic (3xTF32)
in plain torch; the tests and `chip_smoke.py` use it, the port never.
"""
from __future__ import annotations

import torch

from repro_torch.constants import NEG_INF
from repro_torch.kernels.flash_attention.ref import mma_product
from repro_torch.mips.streaming import topk_streaming

__all__ = ["BLOCK_ITEMS", "mips_topk_mma", "mips_topk_ref"]

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


def mips_topk_mma(
    queries: torch.Tensor,  # [B, L] float32
    items: torch.Tensor,  # [P, L] float32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32) as the
    kernel's arithmetic computes the scores: 3xTF32, each operand split
    into big = tf32(x) (to nearest) and small = x - big (cut to tf32 by
    the mma), the two small products summed apart and added to big *
    big in fp32. The [B, P] scores are stored: for small shapes. A row
    short of K items back-fills (NEG_INF, -1); a tie with them loses."""
    b = queries.shape[0]
    scores = mma_product("bl,pl->bp", queries, items, fp32=True)
    ids = torch.arange(items.shape[0], dtype=torch.int32, device=items.device).expand(b, -1)
    dead_s = torch.full((b, k), NEG_INF, dtype=scores.dtype, device=scores.device)
    dead_i = torch.full((b, k), -1, dtype=torch.int32, device=scores.device)
    vals, pos = torch.topk(torch.cat([dead_s, scores], dim=1), k, dim=1)
    return vals, torch.gather(torch.cat([dead_i, ids], dim=1), 1, pos)
