"""The Hopper IVF top-K kernel (`csrc/ivf_topk.cu`), bound with ctypes.

`ivf_probe_topk_cuda` computes what the reference's `ivf_topk_pallas`
computes: the masked top-K over the probed clusters' padded inverted
lists, without materialising the candidate tensor. See the source for
the design and its bound.

The wrapper checks device, dtype, shape and contiguity, sizes the
launch (`splits_for`, `tile_rows`, `lanes_per_row`), allocates the
outputs and the partial top-K scratch with `torch.empty`, launches on
PyTorch's current stream without synchronising, and raises if the
launch is refused. One launch probes and merges (the last block of each
row merges its partial lists; `_launch.ticket_counters`). It counts its
launches in ``ivf_probe_topk_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = [
    "MAX_K", "SOURCE", "ivf_probe_topk_cuda", "ivf_probe_work", "lanes_per_row", "library",
    "splits_for", "tile_rows",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ivf_topk.cu"

# the source's geometry (ivf_topk.cu)
MAX_K = 256  # kp <= 8 * 32 top slots
MAX_CHUNK = 1024  # list slots per block (kMaxChunk)
_STAGE_BYTES = 40 * 1024  # one tile of live rows (kStageBytes)
_MAX_TILE = 256  # live rows per tile (kMaxTile)
_MERGE_ENTRIES = 2 * _STAGE_BYTES // 8  # (score, id) pairs the merge stages at once
# H100 SXM: 132 SMs, two blocks each (the kernel's shared memory allows two)
_TARGET_BLOCKS = 2 * 132


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "ivf_topk_launch", "p" * 9 + "i" * 9 + "p")
    _launch.declare(lib, "ivf_topk_capture_id", "p", ctypes.c_ulonglong)
    _launch.declare(lib, "ivf_topk_error_string", "i", ctypes.c_char_p)
    return lib


def tile_rows(l: int) -> int:
    """Live rows per tile: as many whole rows of L floats as fit 40 KB,
    at most 256. A block copies two tiles before its first wait."""
    t = min(_MAX_TILE, _STAGE_BYTES // (4 * l))
    if t < 1:
        raise ValueError(f"L={l}: one row exceeds the kernel's {_STAGE_BYTES}-byte tile")
    return t


def lanes_per_row(l: int) -> int:
    """G, the lanes that score one row together: a power of two up to a
    warp, about one per 16 of the row's words (16-byte words when L % 4
    == 0, else floats)."""
    words = l // 4 if l % 4 == 0 else l
    return min(32, 1 << max(0, -(-words // 16) - 1).bit_length())


def splits_for(batch: int, n_probe: int, capp: int, k: int, l: int) -> tuple[int, int]:
    """(splits, chunk): each probed list is cut into `splits` ranges of
    `chunk` slots (a multiple of 32, at most 1024), one block each.
    Enough blocks to fill the card at a small batch (`_TARGET_BLOCKS`);
    where it costs at most twice that, ranges short enough that their
    live rows fit the two tiles a block copies at once; and, where the
    fill allows it, few enough partial lists per row (n_probe * splits *
    K pairs) that the merge stages them all at once."""
    fill = -(-_TARGET_BLOCKS // max(1, batch * n_probe))
    by_rows = -(-capp // (2 * tile_rows(l)))
    want = max(fill, by_rows) if by_rows <= 2 * fill else fill
    want = min(want, max(1, _MERGE_ENTRIES // (n_probe * k)))
    want = max(-(-capp // MAX_CHUNK), min(want, -(-capp // 32)))
    per = -(-capp // want)
    chunk = -(-per // 32) * 32
    return -(-capp // chunk), chunk


def ivf_probe_work(b: int, l: int, n_probe: int, capp: int, k: int,
                   live: float | None = None) -> tuple[float, int, float]:
    """(FLOPs of the product, 1, bytes) of one call: each query's probed
    lists' ids read, and the embeddings of their ``live`` slots, summed
    over the queries (by default every slot, B n_probe capp); the
    queries and probe ids read, the [B, K] scores and ids written; 2 L
    FLOPs a live candidate."""
    live = b * n_probe * capp if live is None else live
    nbytes = b * n_probe * capp * 4 + live * 4 * l + b * l * 4 + b * n_probe * 4 + b * k * 8
    return 2 * l * live, 1, nbytes


def ivf_probe_topk_cuda(
    queries: torch.Tensor,  # [B, L] float32
    probe: torch.Tensor,  # [B, n_probe] int32 cluster ids
    lists: torch.Tensor,  # [C, capp] int32 item ids, -1 padded
    list_embs: torch.Tensor,  # [C, capp, L] float32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32) on the card;
    K <= 256."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"ivf_probe_topk_cuda takes CUDA tensors, got {dev}")
    _launch.check("queries", queries, torch.float32, 2, dev)
    _launch.check("probe", probe, torch.int32, 2, dev)
    _launch.check("lists", lists, torch.int32, 2, dev)
    _launch.check("list_embs", list_embs, torch.float32, 3, dev)
    b, l = queries.shape
    n_probe = probe.shape[1]
    c, capp = lists.shape
    if probe.shape[0] != b or list_embs.shape != (c, capp, l):
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, probe "
            f"{tuple(probe.shape)}, lists {tuple(lists.shape)}, list_embs "
            f"{tuple(list_embs.shape)}"
        )
    if min(k, n_probe, b, capp) < 1:
        raise ValueError(
            f"need k, n_probe, B, capp >= 1 (got {k}, {n_probe}, {b}, {capp})"
        )
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K} top slots")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's y limit 65535")
    t, g = tile_rows(l), lanes_per_row(l)
    splits, chunk = splits_for(b, n_probe, capp, k, l)
    if n_probe * splits > _MERGE_ENTRIES:
        raise ValueError(
            f"n_probe * splits = {n_probe * splits} partial lists exceed the merge's "
            f"{_MERGE_ENTRIES} entries"
        )
    lib = library()
    if l % 4 == 0:  # 16-byte copies: the query and every row start on 16 bytes
        queries, list_embs = _launch.aligned16(queries), _launch.aligned16(list_embs)
    stream = _launch.stream(dev)
    counters = _launch.ticket_counters(dev, stream, b, lib.ivf_topk_capture_id(stream))
    part_s = torch.empty((b, n_probe * splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_probe * splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    err = lib.ivf_topk_launch(
        queries.data_ptr(), probe.data_ptr(), lists.data_ptr(),
        list_embs.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), counters.data_ptr(),
        b, l, n_probe, capp, k, splits, chunk, t, g, stream,
    )
    _launch.raise_on_error(err, lib, "ivf_topk_error_string", "ivf_topk")
    ivf_probe_topk_cuda.launches += 1
    return out_s, out_i


ivf_probe_topk_cuda.launches = 0
