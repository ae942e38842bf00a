"""Incremental IVF index maintenance: the refresh path for drifting beta.

The maintained index is a `RefreshState`: the main lists, per-centroid
delta buffers and the mini-batch k-means state. Three ops keep it fresh
at a per-step cost instead of a full `build_ivf`:

  `refresh_step`   mini-batch k-means (Sculley 2010): a fixed-size
                   random minibatch of rows nudges its nearest centroids
                   by a per-centroid count-weighted EMA.
  `delta_append`   new or updated items land in a fixed-capacity
                   per-centroid delta buffer, probed beside the main
                   lists (`refresh_query`, and the delta pass of
                   `repro_torch.kernels.ivf_topk`). The superseded slot
                   of an updated item is tombstoned (-1) through the
                   `slot_of` map, so a stale embedding never shadows its
                   fresh one.
  `compact`        re-buckets everything into the (C, cap) layout the
                   query kernel reads, clearing the delta buffers.

`rebuild` (warm Lloyd iterations, then `compact`) and `sampled_recall`
(the health probe) are the degradation ladder's rungs
(`repro_torch.health.index_health`).

Every op returns a new state and writes none of its input's tensors in
place, so a snapshot that holds a state by reference stays valid. None
reads a device value on the host, so the trainer only launches them:
the next step sees the new state through the stream's order. The
reference drops out-of-range scatters (`mode="drop"`, an out-of-range
sentinel, because -1 would wrap); in torch -1 wraps too and an index
past the end raises, so each scatter here writes its dropped rows to
one spare slot past the end of a copy, which is then cut off.

`refresh_step` draws its rows from a `torch.Generator` where the
reference splits a JAX key: the two are equal in distribution only, and
the rows can be passed in (``rows=``) to replay the reference's.

The sharded (`*_sharded`) ops run the same ops over a stacked per-shard
state (every field with a leading [n] axis, from `build_ivf_sharded`'s
layout: ids GLOBAL, each shard's slab offset baked in), shard by shard
where the reference vmaps. On the grid of `repro_torch.dist` each rank
keeps only the shard of its model coordinate and runs the per-shard op
(``id_base``, ``num_valid``), which gives that shard of the stacked op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.mips.exact import TopK, merge_topk, recall_at_k, topk_exact
from repro_torch.mips.ivf import (
    DEFAULT_N_PROBE,
    IVFIndex,
    ShardedIVFIndex,
    assign_clusters,
    bucket_items,
    build_ivf,
    build_ivf_sharded,
)

__all__ = [
    "RefreshConfig",
    "RefreshState",
    "build_refresh_sharded",
    "build_refresh_state",
    "compact",
    "compact_sharded",
    "delta_append",
    "delta_append_sharded",
    "init_refresh_sharded",
    "init_refresh_state",
    "minibatch_kmeans_step",
    "rebuild",
    "rebuild_sharded",
    "refresh_query",
    "refresh_step",
    "refresh_step_sharded",
    "sampled_recall",
    "shard_states",
    "sharded_as_index",
    "stack_states",
]


@dataclass(frozen=True)
class RefreshConfig:
    """Index-maintenance schedule, validated by `repro_torch.core.plan`.

    every          refresh the centroids every this many train steps
                   (0 disables refresh).
    minibatch      rows sampled per refresh step.
    compact_every  full re-bucket every this many train steps (0
                   disables compaction).
    delta_cap      per-centroid delta-buffer capacity.
    count_decay    per-refresh decay of the k-means EMA counts.
    """

    every: int = 1
    minibatch: int = 1024
    compact_every: int = 64
    delta_cap: int = 64
    count_decay: float = 0.95


class RefreshState(NamedTuple):
    """The maintained index.

    slot_of encodes where each item currently lives:
        main slot (c, s)  ->  c*cap + s
        delta slot (c, s) ->  C*cap + c*delta_cap + s
        absent            ->  -1
    """

    centroids: torch.Tensor  # [C, L]
    counts: torch.Tensor  # [C] f32 — mini-batch k-means EMA weights
    lists: torch.Tensor  # [C, cap] int32 item ids, -1 padded
    list_embs: torch.Tensor  # [C, cap, L] (0 where the list slot is -1)
    delta_lists: torch.Tensor  # [C, dcap] int32 ids, -1 padded
    delta_embs: torch.Tensor  # [C, dcap, L]
    delta_sizes: torch.Tensor  # [C] int32 append high-water marks
    slot_of: torch.Tensor  # [rows] int32 flat slot of each id (see above)
    overflow: torch.Tensor  # [] int32 — items dropped (cap/delta_cap full)

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.lists.shape[1]

    @property
    def delta_cap(self) -> int:
        return self.delta_lists.shape[1]

    def as_index(self, num_items: int) -> IVFIndex:
        """The main lists as a query-ready `IVFIndex` (pair with
        `delta()` to cover the appends not compacted yet)."""
        return IVFIndex(self.centroids, self.lists, self.list_embs, num_items)

    def delta(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (delta_lists, delta_embs) pair probed beside the main lists."""
        return self.delta_lists, self.delta_embs


def _scatter(base: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """A copy of ``base`` (flat on its first axis) with ``values`` written
    at ``idx``; an ``idx`` of ``len(base)`` is dropped (it lands on a
    spare row past the end, which is cut off)."""
    ext = torch.cat([base, base[:1]])
    ext[idx] = values
    return ext[:-1]


# rows of the [rows, C] one-hot a cluster sum takes at a time (2^26 fp32
# entries = 256 MiB), so a 750,000-row rebuild never holds 3 GB
_ONEHOT_ENTRIES = 1 << 26


def _cluster_sums(
    points: torch.Tensor, assign: torch.Tensor, c: int, weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the (weighted) points of each cluster [C, L], the sum of
    their weights [C]), as the reference's `segment_sum`s. A one-hot
    product a chunk of rows at a time, where `index_add_` would add with
    atomics in an order that changes run to run on a GPU: the sums are
    the same bits every run, so a maintained training run repeats."""
    sums = torch.zeros((c, points.shape[1]), dtype=points.dtype, device=points.device)
    cnt = torch.zeros((c,), dtype=points.dtype, device=points.device)
    rows = max(1, _ONEHOT_ENTRIES // max(1, c))
    for lo in range(0, points.shape[0], rows):
        hot = F.one_hot(assign[lo:lo + rows].long(), c).to(points.dtype)  # [r, C]
        if weights is not None:
            hot = hot * weights[lo:lo + rows, None]
        sums = sums + hot.T @ points[lo:lo + rows]
        cnt = cnt + hot.sum(dim=0)
    return sums, cnt


def _main_slot_of(lists: torch.Tensor, rows: int, id_base: int) -> torch.Tensor:
    """[rows] int32: the main slot c*cap + s of each id in ``lists``, -1
    for ids not listed."""
    c, cap = lists.shape
    dev = lists.device
    flat = torch.arange(c * cap, dtype=torch.int32, device=dev)
    local = lists.reshape(-1).long() - id_base
    keep = (lists.reshape(-1) >= 0) & (local >= 0) & (local < rows)
    return _scatter(
        torch.full((rows,), -1, dtype=torch.int32, device=dev),
        torch.where(keep, local, rows), flat,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_refresh_state(
    index: IVFIndex, rows: int, delta_cap: int, *, id_base: int = 0
) -> RefreshState:
    """Wrap a built `IVFIndex` into a `RefreshState` with empty delta
    buffers. `rows` sizes the `slot_of` map (the id space the state may
    see); `id_base` shifts list ids into [0, rows)."""
    c = index.lists.shape[0]
    l = index.centroids.shape[1]
    dev = index.lists.device
    return RefreshState(
        centroids=index.centroids,
        counts=(index.lists >= 0).sum(dim=1).to(torch.float32),
        lists=index.lists,
        list_embs=index.list_embs,
        delta_lists=torch.full((c, delta_cap), -1, dtype=torch.int32, device=dev),
        delta_embs=torch.zeros(
            (c, delta_cap, l), dtype=index.list_embs.dtype, device=dev
        ),
        delta_sizes=torch.zeros((c,), dtype=torch.int32, device=dev),
        slot_of=_main_slot_of(index.lists, rows, id_base),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# mini-batch k-means
# ---------------------------------------------------------------------------

def minibatch_kmeans_step(
    centroids: torch.Tensor,  # [C, L]
    counts: torch.Tensor,  # [C] f32 EMA weights
    batch: torch.Tensor,  # [m, L] sampled rows
    weights: torch.Tensor | None = None,  # [m] f32, optional row mask
    *,
    count_decay: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Sculley-style mini-batch k-means update: assign the batch to
    its nearest centroids, then move each touched centroid toward its
    batch mean with the step  c += m_c / (decay*N_c + m_c) * (mean_c - c).
    decay < 1 forgets old mass geometrically, so the rate floors above
    zero and the centroids keep tracking a drifting distribution."""
    assign = assign_clusters(batch, centroids)  # [m]
    add, cnt = _cluster_sums(batch, assign, centroids.shape[0], weights)
    new_counts = count_decay * counts + cnt
    mean = add / torch.clamp(cnt, min=1.0)[:, None]
    lr = cnt / torch.clamp(new_counts, min=1e-6)  # [C]; 0 where untouched
    return centroids + lr[:, None] * (mean - centroids), new_counts


def refresh_step(
    state: RefreshState,
    generator: torch.Generator | None,
    items: torch.Tensor,  # [rows, L] the CURRENT embedding table
    *,
    minibatch: int,
    count_decay: float = 0.95,
    num_valid: int | None = None,
    rows: torch.Tensor | None = None,
) -> RefreshState:
    """One centroid refresh: sample `minibatch` rows with replacement
    from ``generator`` (on the items' device), or take the given
    ``rows`` [minibatch] ids, and apply one mini-batch k-means step.
    `num_valid` limits the draw to the first rows. Lists are untouched:
    the new centroids only change how later appends and compactions
    bucket."""
    if rows is None:
        rows = torch.randint(
            0, num_valid or items.shape[0], (minibatch,), generator=generator,
            device=items.device,
        )
    batch = items[rows.to(items.device).long()]
    centroids, counts = minibatch_kmeans_step(
        state.centroids, state.counts, batch, count_decay=count_decay
    )
    return state._replace(centroids=centroids, counts=counts)


# ---------------------------------------------------------------------------
# delta-list appends
# ---------------------------------------------------------------------------

def delta_append(
    state: RefreshState,
    ids: torch.Tensor,  # [m] int32 LOCAL ids, -1 marks an unused slot
    embs: torch.Tensor,  # [m, L] their fresh embeddings
    *,
    id_base: int = 0,
) -> RefreshState:
    """Append new or updated items to the per-centroid delta buffers.

    Each valid id goes to its nearest current centroid, at that
    centroid's high-water mark; its previous slot (main or delta) is
    tombstoned through `slot_of`. Appends past `delta_cap` are dropped
    and counted in `overflow` (`compact` folds the full table back in).
    Stored list ids are `ids + id_base`. Ids must be unique within one
    call."""
    c, cap = state.lists.shape
    dcap = state.delta_cap
    rows = state.slot_of.shape[0]
    ids = ids.to(state.lists.device)
    valid = ids >= 0
    safe_ids = ids.clamp(min=0).long()

    assign = assign_clusters(embs, state.centroids).long()  # [m]
    # rank of each valid row within its cluster, in batch order
    onehot = F.one_hot(assign, c).to(torch.int32) * valid[:, None]  # [m, C]
    rank = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1)  # [m]
    pos = state.delta_sizes.long()[assign] + rank  # target delta slot
    ok = valid & (pos < dcap)

    # tombstone the superseded slot (main or delta) of every appended id
    old_flat = state.slot_of[safe_ids].long()  # -1 = not indexed yet
    n_main, n_all = c * cap, c * cap + c * dcap
    flat_lists = torch.cat([state.lists.reshape(-1), state.delta_lists.reshape(-1)])
    flat_lists = _scatter(
        flat_lists, torch.where(ok & (old_flat >= 0), old_flat, n_all),
        torch.full((), -1, dtype=torch.int32, device=flat_lists.device),
    )
    lists = flat_lists[:n_main].reshape(c, cap)

    # the append itself (dropped where not ok)
    d_idx = torch.where(ok, assign * dcap + pos, c * dcap)
    delta_lists = _scatter(
        flat_lists[n_main:], d_idx, (safe_ids + id_base).to(torch.int32)
    ).reshape(c, dcap)
    delta_embs = _scatter(
        state.delta_embs.reshape(c * dcap, -1), d_idx,
        embs.to(state.delta_embs.dtype),
    ).reshape(c, dcap, -1)
    new_flat = (n_main + assign * dcap + pos).to(torch.int32)
    slot_of = _scatter(state.slot_of, torch.where(ok, safe_ids, rows), new_flat)
    added = torch.zeros((c,), dtype=torch.int32, device=ids.device).index_add_(
        0, assign, ok.to(torch.int32)
    )
    overflow = state.overflow + (valid & ~ok).sum().to(torch.int32)
    return state._replace(
        lists=lists,
        delta_lists=delta_lists,
        delta_embs=delta_embs,
        delta_sizes=torch.clamp(state.delta_sizes + added, max=dcap),
        slot_of=slot_of,
        overflow=overflow,
    )


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def compact(
    state: RefreshState,
    items: torch.Tensor,  # [rows, L] the CURRENT embedding table
    *,
    id_base: int = 0,
    num_valid: int | None = None,
) -> RefreshState:
    """Re-bucket the FULL table into fresh main lists under the current
    centroids and clear the delta buffers. Embeddings are regathered
    from `items`, so compaction also folds in drift the delta path never
    saw. Rows past `num_valid` go to the drop bucket, and never reach a
    [C] tensor. Rank overflow past `cap` is dropped and counted in
    `overflow`."""
    c, cap = state.lists.shape
    rows = items.shape[0]
    assign = assign_clusters(items, state.centroids)
    if num_valid is not None:
        keep = torch.arange(rows, device=items.device) < num_valid
        assign = torch.where(keep, assign, c)
    lists, list_embs = bucket_items(assign, items, c, cap)
    n_indexed = (lists >= 0).sum().to(torch.int32)
    n_valid = num_valid if num_valid is not None else rows
    return RefreshState(
        centroids=state.centroids,
        counts=(lists >= 0).sum(dim=1).to(torch.float32),
        lists=torch.where(lists >= 0, lists + id_base, -1).to(torch.int32),
        list_embs=list_embs,
        delta_lists=torch.full_like(state.delta_lists, -1),
        delta_embs=torch.zeros_like(state.delta_embs),
        delta_sizes=torch.zeros_like(state.delta_sizes),
        slot_of=_main_slot_of(lists, rows, 0),
        overflow=n_valid - n_indexed,  # rank-overflow drops this cycle
    )


# ---------------------------------------------------------------------------
# query (plain torch; the kernel route is repro_torch.kernels.ivf_topk)
# ---------------------------------------------------------------------------

def refresh_query(
    state: RefreshState,
    queries: torch.Tensor,  # [B, L]
    k: int,
    n_probe: int = DEFAULT_N_PROBE,
    *,
    id_base: int = 0,  # noqa: ARG001 — the reference's signature; ids are global
) -> TopK:
    """Query the main lists AND the delta buffers of the probed
    centroids and merge (`merge_topk`). The plain version of the kernel
    route's ``delta=`` probe. List ids are already global, so
    ``id_base`` changes nothing, as in the reference."""
    n_probe = min(n_probe, state.num_clusters)
    probe = torch.topk(queries @ state.centroids.T, n_probe, dim=1).indices
    b = queries.shape[0]

    def gather_score(lists, embs):
        ids = lists[probe].reshape(b, -1)
        e = embs[probe].reshape(b, ids.shape[1], -1)
        return torch.einsum("bl,bnl->bn", queries, e), ids

    s_main, i_main = gather_score(state.lists, state.list_embs)
    s_delta, i_delta = gather_score(state.delta_lists, state.delta_embs)
    return merge_topk(
        torch.cat([s_main, s_delta], dim=-1), torch.cat([i_main, i_delta], dim=-1), k
    )


# ---------------------------------------------------------------------------
# health probe + rebuild (the degradation ladder's rungs)
# ---------------------------------------------------------------------------

def sampled_recall(
    state: RefreshState,
    items: torch.Tensor,  # [P, L] the CURRENT embedding table
    queries: torch.Tensor,  # [B, L] held probe set
    k: int,
    *,
    n_probe: int = DEFAULT_N_PROBE,
    dist=None,
) -> float:
    """Recall@k of the maintained index (main lists + delta buffers,
    `refresh_query`) against exact top-k over `items` on a held probe
    set: the ladder's periodic health probe. It reads the result on the
    host. ``state`` is one state, or the stacked per-shard layout (the
    shards' answers merged through `merge_topk`, ids already global).

    With ``dist`` (a `repro_torch.dist.DistConfig`) ``state`` is this
    rank's shard and ``items`` its slab: the shards' answers and the
    exact top-k are merged over the model group, so every rank of it
    gets the same recall (all of them must call it)."""
    if dist is not None:
        from repro_torch.dist.fopo import dist_sharded_topk
        from repro_torch.mips.sharded import merge_topk_along_axis

        loc = refresh_query(state, queries, k, n_probe)
        approx = merge_topk_along_axis(loc.scores, loc.indices, k, dist.model_group)
        # the maintained dist route has no pad rows (P % n_model == 0)
        return recall_at_k(approx, dist_sharded_topk(queries, items, k, dist))
    exact = topk_exact(queries, items, k)
    if state.centroids.dim() == 3:  # stacked [n, ...] per-shard states
        per = [refresh_query(st, queries, k, n_probe) for st in shard_states(state)]
        approx = merge_topk(
            torch.cat([t.scores for t in per], dim=1),
            torch.cat([t.indices for t in per], dim=1), k,
        )
    else:
        approx = refresh_query(state, queries, k, n_probe)
    return recall_at_k(approx, exact)


def rebuild(
    state: RefreshState,
    items: torch.Tensor,  # [rows, L] the CURRENT embedding table
    *,
    iters: int = 4,
    id_base: int = 0,
    num_valid: int | None = None,
) -> RefreshState:
    """Full index rebuild, warm-started: `iters` Lloyd iterations over
    the whole table from the CURRENT centroids (no re-seeding), then a
    `compact` re-bucket. Empty clusters keep their centroid. The
    ladder's second rung: it heals centroid drift a compaction can't."""
    w = None
    if num_valid is not None:
        w = (torch.arange(items.shape[0], device=items.device) < num_valid).to(items.dtype)
    cent = state.centroids
    for _ in range(iters):
        assign = assign_clusters(items, cent)
        add, cnt = _cluster_sums(items, assign, state.num_clusters, w)
        cent = torch.where(
            cnt[:, None] > 0, add / torch.clamp(cnt, min=1.0)[:, None], cent
        )
    return compact(
        state._replace(centroids=cent), items, id_base=id_base, num_valid=num_valid
    )


# ---------------------------------------------------------------------------
# build + wrap in one call
# ---------------------------------------------------------------------------

def build_refresh_state(
    items: torch.Tensor,
    num_clusters: int,
    cap: int,
    *,
    delta_cap: int = 64,
    kmeans_iters: int = 12,
    cap_tile: int | None = None,
    seed: int = 0,
    device=None,
) -> RefreshState:
    """`build_ivf` (both num_clusters and cap given: the build trusts
    cap) wrapped into a maintainable `RefreshState` on ``device``
    (default "cuda")."""
    index = build_ivf(
        items, num_clusters, cap, kmeans_iters, cap_tile=cap_tile, seed=seed,
        device=device,
    )
    return init_refresh_state(index, items.shape[0], delta_cap)


# ---------------------------------------------------------------------------
# the sharded route: stacked per-shard states, the ops shard by shard
# ---------------------------------------------------------------------------

def shard_states(state: RefreshState) -> list[RefreshState]:
    """The per-shard states of a stacked [n, ...] state."""
    return [RefreshState(*(t[d] for t in state)) for d in range(state.centroids.shape[0])]


def stack_states(states: list[RefreshState]) -> RefreshState:
    """The stacked [n, ...] state of per-shard states (their caps equal)."""
    return RefreshState(*(torch.stack(ts) for ts in zip(*states)))


def _slabs(items: torch.Tensor, n: int) -> tuple[int, list[torch.Tensor], list[int]]:
    """(rows, the n zero-padded row slabs, each slab's valid rows)."""
    p, l = items.shape
    rows = -(-p // n)
    pad = n * rows - p
    if pad:
        items = torch.cat([items, items.new_zeros((pad, l))])
    slabs = [items[d * rows:(d + 1) * rows] for d in range(n)]
    return rows, slabs, [min(max(p - d * rows, 0), rows) for d in range(n)]


def init_refresh_sharded(index: ShardedIVFIndex, delta_cap: int) -> RefreshState:
    """Stacked per-shard states ([n, ...] on every field) from
    `build_ivf_sharded`'s global-id layout."""
    n = index.n_shards
    rows = -(-index.num_items // n)
    return stack_states([
        init_refresh_state(index.shard(d), rows, delta_cap, id_base=d * rows)
        for d in range(n)
    ])


def refresh_step_sharded(
    state: RefreshState,  # stacked [n, ...]
    generator: torch.Generator | None,
    items: torch.Tensor,  # [P, L] the full table
    *,
    minibatch: int,
    count_decay: float = 0.95,
    rows: torch.Tensor | None = None,  # [n, minibatch] injected slab rows
) -> RefreshState:
    """Per-shard mini-batch k-means over each shard's own row slab (each
    shard samples from the rows it indexes; a ragged tail slab draws
    from its valid rows only). The draws come from one generator, shard
    after shard, or from the injected ``rows``."""
    n = state.centroids.shape[0]
    _, slabs, valids = _slabs(items, n)
    return stack_states([
        refresh_step(st, generator, slab, minibatch=minibatch, count_decay=count_decay,
                     num_valid=max(nv, 1), rows=None if rows is None else rows[d])
        for d, (st, slab, nv) in enumerate(zip(shard_states(state), slabs, valids))
    ])


def delta_append_sharded(
    state: RefreshState,  # stacked [n, ...]
    ids: torch.Tensor,  # [m] int32 GLOBAL ids, -1 = unused slot
    embs: torch.Tensor,  # [m, L]
    num_items: int,
) -> RefreshState:
    """Route each updated item to the shard that owns its row slab: every
    shard sees the whole batch and keeps its own rows (the others become
    -1 no-ops)."""
    n = state.centroids.shape[0]
    rows = -(-num_items // n)
    out = []
    for d, st in enumerate(shard_states(state)):
        local = ids.long() - d * rows
        mine = (ids >= 0) & (local >= 0) & (local < rows)
        out.append(delta_append(st, torch.where(mine, local, -1), embs, id_base=d * rows))
    return stack_states(out)


def compact_sharded(state: RefreshState, items: torch.Tensor) -> RefreshState:
    """Per-shard compaction over each shard's row slab (global ids)."""
    n = state.centroids.shape[0]
    rows, slabs, valids = _slabs(items, n)
    return stack_states([
        compact(st, slab, id_base=d * rows, num_valid=nv)
        for d, (st, slab, nv) in enumerate(zip(shard_states(state), slabs, valids))
    ])


def rebuild_sharded(state: RefreshState, items: torch.Tensor, *, iters: int = 4) -> RefreshState:
    """Per-shard warm rebuild over each shard's row slab (global ids)."""
    n = state.centroids.shape[0]
    rows, slabs, valids = _slabs(items, n)
    return stack_states([
        rebuild(st, slab, iters=iters, id_base=d * rows, num_valid=nv)
        for d, (st, slab, nv) in enumerate(zip(shard_states(state), slabs, valids))
    ])


def sharded_as_index(state: RefreshState, num_items: int) -> ShardedIVFIndex:
    """The stacked main lists as the `ShardedIVFIndex` the dist query
    route reads."""
    return ShardedIVFIndex(state.centroids, state.lists, state.list_embs, num_items)


def build_refresh_sharded(
    items: torch.Tensor,
    n_shards: int,
    num_clusters: int,
    cap: int,
    *,
    delta_cap: int = 64,
    kmeans_iters: int = 12,
    cap_tile: int | None = None,
    seed: int = 0,
    device=None,
) -> RefreshState:
    """`build_ivf_sharded` wrapped into stacked per-shard states."""
    index = build_ivf_sharded(
        items, n_shards, num_clusters, cap, kmeans_iters, cap_tile=cap_tile, seed=seed,
        device=device,
    )
    return init_refresh_sharded(index, delta_cap)
