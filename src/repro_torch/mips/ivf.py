"""IVF-Flat MIPS index: k-means centroids plus padded inverted lists.

  build (once; the item table is fixed while it serves):
    k-means over the items -> C centroids; items bucketed by nearest
    centroid into padded inverted lists [C, cap] (cap = padded largest
    cluster), with their embeddings gathered to [C, cap, L].
  query:
    (B, L) x (L, C) centroid scores -> top n_probe clusters -> score
    their lists -> masked top-K.

`ivf_query` below is the plain query, which gathers the
[B, n_probe*cap, L] candidate tensor; the kernel-grade query that never
builds it is `repro_torch.kernels.ivf_topk`, over the same `IVFIndex`.
`build_ivf_sharded` builds one local index per row slab of the dist
step's partition (global ids baked in), stacked as a `ShardedIVFIndex`
(`repro_torch.dist.fopo.dist_ivf_topk`).

The port draws its k-means++ seeds with `torch.multinomial` from a seeded
`torch.Generator`, where the reference uses `jax.random.categorical`, so
the two packages build different indexes from one seed; the parity tests
carry the reference's index across instead (`repro_torch.convert`).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.mips.exact import TopK, merge_topk

__all__ = [
    "DEFAULT_CAP_TILE",
    "DEFAULT_N_PROBE",
    "IVFIndex",
    "ShardedIVFIndex",
    "assign_clusters",
    "bucket_items",
    "build_ivf",
    "build_ivf_sharded",
    "ivf_query",
    "kmeans",
    "resolve_cap",
    "resolve_cap_tile",
]

DEFAULT_CAP_TILE = 256
DEFAULT_N_PROBE = 8  # clusters probed per query — one default, every route

# rows of the [rows, C] score matrix `assign_clusters` makes at a time
# (2^28 fp32 scores = 1 GiB), so a million-item build never holds 4 GB
_ASSIGN_SCORES = 1 << 28


def resolve_cap_tile(cap_tile: int | None, cap: int) -> int:
    """The reference's cap-tile rule: clamp to the list capacity, then
    round down to a multiple of 8; widths below 8 pass through."""
    ct = min(cap_tile or DEFAULT_CAP_TILE, cap)
    if ct >= 8:
        ct -= ct % 8
    return ct


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # [C, L]
    lists: torch.Tensor  # [C, cap] int32 item ids, -1 padded
    list_embs: torch.Tensor  # [C, cap, L] gathered item embeddings (0 padded)
    num_items: int


class ShardedIVFIndex(NamedTuple):
    """One IVF index per row slab (the `model` shards of the dist step),
    stacked on a leading axis: shard d's lists hold GLOBAL item ids (its
    slab offset baked in), so per-shard query results merge unchanged."""

    centroids: torch.Tensor  # [n, C, L]
    lists: torch.Tensor  # [n, C, cap] int32 GLOBAL ids, -1 padded
    list_embs: torch.Tensor  # [n, C, cap, L]
    num_items: int

    @property
    def n_shards(self) -> int:
        return self.centroids.shape[0]

    def shard(self, d: int) -> IVFIndex:
        return IVFIndex(self.centroids[d], self.lists[d], self.list_embs[d], self.num_items)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def assign_clusters(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The L2 nearest-centroid rule: argmin ||x - c||^2 = argmax
    (x.c - ||c||^2/2). Returns [P] int32."""
    c_norm = 0.5 * torch.sum(centroids**2, dim=-1)  # [C]
    rows = max(1, _ASSIGN_SCORES // max(1, centroids.shape[0]))
    out = [
        torch.argmax(chunk @ centroids.T - c_norm[None, :], dim=-1)
        for chunk in points.split(rows)
    ]
    return torch.cat(out).to(torch.int32)


def _kmeanspp_init(
    points: torch.Tensor, num_clusters: int, generator: torch.Generator
) -> torch.Tensor:
    """D^2-weighted (k-means++) seeding: each next seed is drawn with
    probability proportional to its squared distance from the seeds so
    far, which keeps the inverted lists balanced."""
    p, l = points.shape
    first = points[
        torch.randint(0, p, (1,), generator=generator, device=points.device)
    ]  # [1, L]
    d2 = torch.sum((points - first) ** 2, dim=-1)  # [P]
    centroids = torch.empty((num_clusters, l), dtype=points.dtype, device=points.device)
    centroids[:1] = first
    for i in range(1, num_clusters):
        # the tiny floor keeps the draw defined once every point is
        # within eps of a chosen centroid
        idx = torch.multinomial(d2 + 1e-20, 1, generator=generator)
        nxt = points[idx]  # [1, L]
        d2 = torch.minimum(d2, torch.sum((points - nxt) ** 2, dim=-1))
        centroids[i : i + 1] = nxt
    return centroids


def kmeans(
    points: torch.Tensor,
    num_clusters: int,
    iters: int = 12,
    *,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means from k-means++ seeds. Returns (centroids [C, L],
    assignment [P] int32)."""
    p, l = points.shape
    if num_clusters > p:
        warnings.warn(
            f"kmeans: num_clusters={num_clusters} > {p} points; clamping "
            f"to {p} (one cluster per point)",
            stacklevel=2,
        )
        num_clusters = p
    centroids = _kmeanspp_init(points, num_clusters, generator)
    ones = torch.ones((p,), dtype=points.dtype, device=points.device)
    for _ in range(iters):
        assign = assign_clusters(points, centroids).long()
        sums = torch.zeros_like(centroids).index_add_(0, assign, points)
        counts = torch.zeros(
            (num_clusters,), dtype=points.dtype, device=points.device
        ).index_add_(0, assign, ones)
        new_c = sums / torch.clamp(counts[:, None], min=1.0)
        # keep empty clusters where they were
        centroids = torch.where(counts[:, None] > 0, new_c, centroids)
    return centroids, assign_clusters(points, centroids)


# ---------------------------------------------------------------------------
# index build / query
# ---------------------------------------------------------------------------

def bucket_items(
    assign: torch.Tensor,  # [P] int32 cluster of each item (or C = drop)
    items: torch.Tensor,  # [P, L]
    num_clusters: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-sort items by cluster, slot = rank within its cluster, into
    a [C, cap] id table (-1 padded) and the matching [C, cap, L]
    embeddings (0 padded).

    Items whose rank overflows `cap`, or whose assignment is the drop
    bucket `num_clusters`, are dropped from the lists. The reference
    drops them with a scatter in mode "drop"; PyTorch raises on an
    out-of-range index, so they are written to one spare slot past the
    table, which is then cut off. Nothing here reads a device value on
    the host (the cluster counts are an `index_add_`: `torch.bincount`
    reads its input's maximum on the host), so the index maintenance
    that calls it only launches."""
    p = assign.shape[0]
    dev = assign.device
    assign = assign.long()
    counts = torch.zeros((num_clusters + 1,), dtype=torch.long, device=dev).index_add_(
        0, assign, torch.ones_like(assign)
    )
    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    onset = torch.cumsum(counts, 0) - counts
    rank = torch.arange(p, device=dev) - onset[sorted_assign]
    keep = (sorted_assign < num_clusters) & (rank < cap)
    spare = num_clusters * cap
    slot = torch.where(keep, sorted_assign * cap + rank, spare)
    lists = torch.full((spare + 1,), -1, dtype=torch.int32, device=dev)
    lists[slot] = order.to(torch.int32)
    lists = lists[:spare].reshape(num_clusters, cap)
    live = lists >= 0
    list_embs = torch.where(
        live[..., None], items[lists.clamp(min=0).long()], 0.0
    )
    return lists, list_embs


def resolve_cap(cap: int, cap_tile: int | None) -> int:
    """Round a requested list capacity up to the cap tile (the
    multiple-of-8 `resolve_cap_tile` rule)."""
    if cap_tile is None:
        return cap
    ct = resolve_cap_tile(cap_tile, max(cap, cap_tile))
    return -(-cap // ct) * ct


def default_num_clusters(p: int) -> int:
    """2^round(log2 sqrt(P)), computed in float32 as the reference does."""
    return max(1, int(2 ** round(float(np.log2(np.sqrt(np.float32(p)))))))


def build_ivf(
    items: torch.Tensor,
    num_clusters: int | None = None,
    cap: int | None = None,
    kmeans_iters: int = 12,
    *,
    cap_tile: int | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> IVFIndex:
    """Cluster and bucket `items` into padded inverted lists on ``device``
    (default "cuda"; see `repro_torch.device`), seeding k-means from a
    `torch.Generator` seeded with ``seed``.

    ``cap_tile`` rounds the list capacity up to a multiple of the cap
    tile. With both ``num_clusters`` and ``cap`` given, the build makes
    no host round-trip and trusts ``cap``: items of a cluster past it
    are dropped. With ``cap=None`` the capacity comes from the largest
    cluster (rounded up to a power of two), with the reference's
    warnings for a cap below it and for a degenerate clustering."""
    dev = resolve_device(device)
    items = items.to(dev, torch.float32)
    p = items.shape[0]
    generator = torch.Generator(device=dev).manual_seed(seed)
    if num_clusters is None:
        num_clusters = default_num_clusters(p)
        static = False
    else:
        static = cap is not None
    centroids, assign = kmeans(items, num_clusters, kmeans_iters, generator=generator)
    num_clusters = centroids.shape[0]  # kmeans clamps > P (with warning)

    if static:
        lists, list_embs = bucket_items(
            assign, items, num_clusters, resolve_cap(cap, cap_tile)
        )
        return IVFIndex(centroids, lists, list_embs, num_items=p)

    max_count = int(torch.bincount(assign.long(), minlength=num_clusters).max())
    if cap is not None and cap < max_count:
        warnings.warn(
            f"build_ivf: requested cap={cap} < largest cluster "
            f"({max_count} items); clamping cap to {max_count}",
            stacklevel=2,
        )
        cap = max_count
    if cap is None:
        cap = int(2 ** float(np.ceil(np.log2(np.float32(max(max_count, 1))))))
    cap = resolve_cap(max(cap, max_count), cap_tile)
    if num_clusters > 1 and p >= 256 and max_count > p / 2:
        warnings.warn(
            f"build_ivf: degenerate clustering — largest cluster holds "
            f"{max_count}/{p} items; queries probing it cost O(P*L)",
            stacklevel=2,
        )
    lists, list_embs = bucket_items(assign, items, num_clusters, cap)
    return IVFIndex(centroids, lists, list_embs, num_items=p)


def build_ivf_sharded(
    items: torch.Tensor,
    n_shards: int,
    num_clusters: int | None = None,
    cap: int | None = None,
    kmeans_iters: int = 12,
    *,
    cap_tile: int | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> ShardedIVFIndex:
    """One IVF index per contiguous row slab of `items` (the dist step's
    ceil partition, `pad_rows`' rule), padded to common [C, cap] shapes
    and stacked. List ids are GLOBAL; a ragged tail slab is zero-padded
    before clustering and its pad entries are masked back out of the
    lists (-1, zero embeddings). Shard d's k-means is seeded with
    ``seed + d`` (the reference folds the shard into its key)."""
    p, l = items.shape
    rows = -(-p // n_shards)
    if num_clusters is None:
        num_clusters = default_num_clusters(rows)
    num_clusters = min(num_clusters, rows)
    parts = []
    for d in range(n_shards):
        slab = items[d * rows:min(p, (d + 1) * rows)]
        if slab.shape[0] < rows:  # ragged tail: cluster over zero pad rows
            slab = torch.cat([slab, slab.new_zeros((rows - slab.shape[0], l))])
        parts.append(build_ivf(slab, num_clusters, cap, kmeans_iters, cap_tile=cap_tile,
                               seed=seed + d, device=device))
    cap_max = max(ix.lists.shape[1] for ix in parts)
    if cap_tile is not None:
        ct = resolve_cap_tile(cap_tile, max(cap_max, cap_tile))
        cap_max = -(-cap_max // ct) * ct
    lists, embs = [], []
    for d, ix in enumerate(parts):
        pad = cap_max - ix.lists.shape[1]
        li = torch.nn.functional.pad(ix.lists, (0, pad), value=-1)
        em = torch.nn.functional.pad(ix.list_embs, (0, 0, 0, pad))
        gids = torch.where(li >= 0, li + d * rows, -1)
        dead = gids >= p  # the ragged tail's pad rows
        lists.append(torch.where(dead, -1, gids).to(torch.int32))
        embs.append(torch.where(dead[..., None], 0.0, em))
    return ShardedIVFIndex(
        centroids=torch.stack([ix.centroids for ix in parts]),
        lists=torch.stack(lists),
        list_embs=torch.stack(embs),
        num_items=p,
    )


def ivf_query(
    index: IVFIndex, queries: torch.Tensor, k: int, n_probe: int = DEFAULT_N_PROBE
) -> TopK:
    """queries [B, L] -> approximate TopK([B, K]), the plain query that
    gathers the candidate tensor."""
    n_probe = min(n_probe, index.centroids.shape[0])
    probe = torch.topk(queries @ index.centroids.T, n_probe, dim=1).indices
    b = queries.shape[0]
    cand_ids = index.lists[probe].reshape(b, -1)  # [B, n_probe*cap]
    cand_embs = index.list_embs[probe].reshape(b, cand_ids.shape[1], -1)
    scores = torch.einsum("bl,bnl->bn", queries, cand_embs)
    return merge_topk(scores, cand_ids, k)
