"""Exact (dense) maximum-inner-product search and the shared K-merge.

`topk_exact` is one matmul and `torch.topk`: the serving route's exact
fallback, and the oracle of the approximate retrievers. `merge_topk` is
the masked candidate merge the IVF main + delta passes share.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.constants import NEG_INF

__all__ = ["TopK", "merge_topk", "recall_at_k", "topk_exact"]


class TopK(NamedTuple):
    scores: torch.Tensor  # [B, K] descending
    indices: torch.Tensor  # [B, K] int32 global item ids


def _top(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, descending, equal scores in their
    order in the row (the reference's `lax.top_k` rule, lower index
    first): a stable sort, where `torch.topk` leaves the order of ties
    open, so the streaming, sharded and IVF routes, which all end in
    `merge_topk`, pick the same ids among equal scores."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def topk_exact(queries: torch.Tensor, items: torch.Tensor, k: int) -> TopK:
    """queries [B, L], items [P, L] -> top-k by inner product."""
    vals, idx = torch.topk(queries @ items.T, k, dim=1)
    return TopK(scores=vals, indices=idx.to(torch.int32))


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> TopK:
    """[B, K'] scored candidates -> TopK([B, K]). An id of -1 marks a
    dead slot: its score is demoted to NEG_INF, so it can only
    back-fill. Equal scores keep their candidates' order."""
    scores = torch.where(ids >= 0, scores, NEG_INF)
    vals, pos = _top(scores, k)
    return TopK(scores=vals, indices=torch.gather(ids, 1, pos).to(torch.int32))


def recall_at_k(approx: TopK, exact: TopK) -> float:
    """Mean per-row fraction of the exact top-K ids the approximate
    retriever recovered (-1 back-fill never matches)."""
    k = exact.indices.shape[-1]
    a = approx.indices.cpu().tolist()
    e = exact.indices.cpu().tolist()
    return sum(len(set(ar) & set(er)) / k for ar, er in zip(a, e)) / len(e)
