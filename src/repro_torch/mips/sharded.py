"""Distributed MIPS over a row-sharded catalog, one process per shard.

The item matrix beta [P, L] is split into row slabs over a process group
(the `model` group of `repro_torch.dist.DistConfig`). Each rank computes
a local top-K over its slab with the plain streaming scan
(`mips.streaming.topk_streaming`, as the reference's local retrieval is
`topk_streaming`), then the [n, B, K] candidates are all-gathered over
the group and reduced to the global top-K by `merge_topk`.
Communication is O(n B K), never O(P). The functions take the group
where the reference names a mesh axis; every rank of the group calls
them together.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from repro_torch.mips.exact import TopK, merge_topk
from repro_torch.mips.streaming import topk_streaming

__all__ = [
    "context_sharded_topk",
    "make_sharded_topk_fn",
    "merge_topk_along_axis",
    "sharded_gather_rows",
    "sharded_topk",
]


def merge_topk_along_axis(
    scores: torch.Tensor,  # [B, K'] local candidate scores
    gids: torch.Tensor,  # [B, K'] GLOBAL candidate ids, -1 marks dead slots
    k: int,
    group,
) -> TopK:
    """All-gather each rank's [B, K'] candidates over ``group`` and reduce
    them to the global TopK([B, K]) through `merge_topk` (id -1 scores
    NEG_INF and only back-fills): the exact and the IVF routes both end
    here. Each row's candidates are laid out shard by shard, as the
    reference's transposed gather."""
    from repro_torch.dist.collectives import all_gather

    cat_s = all_gather(scores.float(), group, dim=1, name="topk_merge")
    cat_i = all_gather(gids.to(torch.int32), group, dim=1, name="topk_merge")
    return merge_topk(cat_s, cat_i, k)


def sharded_topk(
    queries: torch.Tensor,  # [B, L] the same on every rank of the group
    items_shard: torch.Tensor,  # [rows, L] this rank's slab
    k: int,
    group,
    block_items: int = 4096,
    num_valid: int | None = None,
) -> TopK:
    """The global TopK [B, K] over the slabs of ``group``'s ranks.

    ``num_valid`` masks the tail of a zero-padded catalog: the local top-K
    is widened by the pad count (pad rows score exactly 0 and could
    otherwise evict a real negative-scoring item before masking), then ids
    >= num_valid are demoted to id -1 before the merge."""
    n = tdist.get_world_size(group)
    shard_id = tdist.get_rank(group)
    rows = items_shard.shape[0]
    local_k = k
    if num_valid is not None:
        local_k = k + max(0, n * rows - num_valid)
    local = topk_streaming(queries, items_shard, local_k, block_items=block_items)
    gids = torch.where(local.indices >= 0, local.indices + shard_id * rows, -1)
    if num_valid is not None:
        gids = torch.where(gids < num_valid, gids, -1)
    return merge_topk_along_axis(local.scores, gids.to(torch.int32), k, group)


def make_sharded_topk_fn(group, k: int, block_items: int = 4096):
    """f(queries [B, L], items_shard [rows, L]) -> TopK: queries and the
    result the same on every rank, items row-sharded over ``group``."""

    def fn(queries, items_shard):
        return sharded_topk(queries, items_shard, k, group, block_items)

    return fn


def context_sharded_topk(
    queries: torch.Tensor,  # [B_local, L] this rank's rows of the batch
    items_shard: torch.Tensor,  # [rows, L] this rank's slab
    k: int,
    *,
    dist,  # DistConfig: queries split over `data`, items over `model`
    block_items: int = 8192,
    num_valid: int | None = None,
) -> TopK:
    """The 2-D distributed top-K: each rank scans its (B_local x rows)
    tile and merges candidates along `model` only, communication
    O(n_model B_local K)."""
    return sharded_topk(queries, items_shard, k, dist.model_group, block_items, num_valid)


def sharded_gather_rows(
    table_shard: torch.Tensor,  # [rows, D] this rank's slab
    ids: torch.Tensor,  # [...] global int ids, the same on every rank
    group,
) -> torch.Tensor:
    """A gather from a row-sharded table, the same on every rank: mask,
    local take, then a sum over ``group`` (each id's owner gives its row,
    every other rank exact zeros)."""
    from repro_torch.dist.collectives import all_reduce

    shard_id = tdist.get_rank(group)
    rows = table_shard.shape[0]
    local = ids.long() - shard_id * rows
    mine = (local >= 0) & (local < rows)
    vals = table_shard[local.clamp(0, rows - 1)]
    vals = torch.where(mine[..., None], vals, 0.0)
    return all_reduce(vals, group=group, name="gather_rows")
