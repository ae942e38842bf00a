"""The maintained IVF index: main lists plus per-centroid delta buffers.

This slice ports what serving reads: `RefreshConfig`, the `RefreshState`
layout with its query views (`as_index`, `delta`) and
`init_refresh_state`, which wraps a built index. Serving schedules no
maintenance (every=0), so the delta buffers stay empty unless a caller
fills them. The maintenance ops themselves (mini-batch k-means refresh,
delta append, compaction, rebuild) come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.mips.ivf import IVFIndex

__all__ = ["RefreshConfig", "RefreshState", "init_refresh_state"]


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


def init_refresh_state(
    index: IVFIndex, rows: int, delta_cap: int, *, id_base: int = 0
) -> RefreshState:
    """Wrap a built `IVFIndex` into a `RefreshState` with empty delta
    buffers. `rows` sizes the `slot_of` map (the id space the state may
    see); `id_base` shifts list ids into [0, rows).

    Dead list slots go nowhere: the reference scatters them to the
    out-of-range sentinel `rows` in mode "drop", and PyTorch would raise
    on it (or wrap a -1 to the last row), so they are masked out here."""
    c, cap = index.lists.shape
    l = index.centroids.shape[1]
    dev = index.lists.device
    flat = torch.arange(c * cap, dtype=torch.int32, device=dev).reshape(c, cap)
    local = index.lists.long() - id_base
    keep = (index.lists >= 0) & (local >= 0) & (local < rows)
    slot_of = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    slot_of[local[keep]] = flat[keep]
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
        slot_of=slot_of,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )
