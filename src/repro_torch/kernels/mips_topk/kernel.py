"""The Hopper exact top-K MIPS kernel (`csrc/mips_topk.cu`), bound with
ctypes.

`mips_topk_cuda` computes what the reference's `mips_topk_pallas`
computes: the exact top-K of queries @ items.T over the whole catalog,
sorted descending, without storing the [B, P] score matrix. See the
source for the design and its bound.

The wrapper checks device, dtype, shape and contiguity, cuts the catalog
into about one chunk per SM, sizes the ring of catalog tiles to the
shared memory left beside the top-K state (`ring_stages`), allocates the
outputs and the partial top-K scratch with `torch.empty`, launches on
PyTorch's current stream without synchronising, and raises if the
launch is refused. It counts its launches in
``mips_topk_cuda.launches``. Given a ``counters`` buffer (int64, one
entry a name of `COUNT_FIELDS`), the probe kernel's counting
instantiation runs and adds its counts into it; without one the plain
instantiation runs.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = [
    "COUNT_FIELDS", "MAX_K", "SOURCE", "TILE_ITEMS", "chunks_for", "library", "mips_topk_cuda",
    "mips_topk_work", "ring_stages", "sample_rows", "stage_bytes",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "mips_topk.cu"

# the source's geometry (mips_topk.cu: kTileItems, kTop, kTileQ * kSlots
# (score, id) pairs, kMaxStages)
TILE_ITEMS = 64  # catalog rows per tile, one bulk copy each
MAX_K = 256  # top slots per query
_STATE_BYTES = 32 * (256 + 192) * 8
_MAX_STAGES = 4
_SAMPLE_MAX = 8192  # sampled rows of the floor, at most (kSampleMax)
_SAMPLE_ROWS = 64  # sampled rows per block of the sample kernel (kSampleRows)
# the most shared memory a Hopper block can use, less 1 KB for the
# kernel's static shared memory (thresholds, counts, mbarriers)
_SMEM_BUDGET = 232_448 - 1024
# the counting probe kernel's fields (mips_topk.cu: CountField): queries,
# 64-row tiles scored, candidates appended past the gate, query buffers
# folded in the scan, and the scoring warps' clock cycles waiting for a
# full stage, in the products, in the appends (with the team's barrier)
# and in the folds (with theirs, and the last fold and sort)
COUNT_FIELDS = ("queries", "tiles", "appends", "folds", "wait_cycles", "product_cycles",
                "append_cycles", "fold_cycles")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "mips_topk_launch", "p" * 9 + "i" * 9 + "pip")
    _launch.declare(lib, "mips_topk_error_string", "i", ctypes.c_char_p)
    return lib


def chunks_for(p: int, tile: int, sms: int) -> tuple[int, int]:
    """(chunks, rows per chunk): the catalog cut into about one chunk per
    SM, each a whole number of the kernel's tiles. More chunks would fill
    the card no better (the probe kernel runs one block per SM) and give
    the merge more partial lists."""
    tiles = max(1, -(-p // tile))
    want = max(1, min(sms, tiles))
    per = -(-tiles // want) * tile
    return -(-p // per), per


def stage_bytes(l: int) -> int:
    """Shared memory of one ring stage: a tile of 64 rows of L floats and
    32 bytes of zeros, rounded up to 128 bytes."""
    return (TILE_ITEMS * l * 4 + 32 + 127) // 128 * 128


def ring_stages(l: int) -> int:
    """Catalog tiles the probe kernel keeps in flight: as many stages as
    fit beside the 32 queries' top-K state, up to 4 (3 tiles copied while
    one is scored), at least 2. Raises for an L whose two stages do not
    fit (L > 227)."""
    n = min(_MAX_STAGES, (_SMEM_BUDGET - _STATE_BYTES) // stage_bytes(l))
    if n < 2:
        raise ValueError(
            f"L={l}: two tiles of {stage_bytes(l)} bytes beside the top-K state "
            f"({_STATE_BYTES} bytes) need more shared memory than a Hopper block has"
        )
    return n


def sample_rows(p: int) -> tuple[int, int]:
    """(stride, m): the floor's sample, every stride-th catalog row, m rows
    (at most 8192, stride at least 64). Its K-th score bounds the K-th of
    the catalog from below, so about K * stride rows of the catalog pass
    it (K * 64 at P 750,000, against ~1,000 a query in each of the 132
    chunks without it)."""
    stride = max(64, -(-p // _SAMPLE_MAX))
    return stride, -(-p // stride)


def mips_topk_work(b: int, p: int, l: int, k: int) -> tuple[int, int, int]:
    """(FLOPs of the product, 1, bytes) of one call: the catalog and the
    queries read once, the [B, K] scores and ids written once; 2 B P L
    FLOPs for queries @ items.T, whose [B, P] scores are never stored."""
    return 2 * b * p * l, 1, p * l * 4 + b * l * 4 + b * k * 8


def _launch_args(queries, items, k, counters=None):
    """(library, launch arguments but `which` and the stream, outputs):
    the checks and the buffers of one call."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"mips_topk_cuda takes CUDA tensors, got {dev}")
    _launch.check("queries", queries, torch.float32, 2, dev)
    _launch.check("items", items, torch.float32, 2, dev)
    b, l = queries.shape
    p = items.shape[0]
    if items.shape[1] != l:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, items {tuple(items.shape)}"
        )
    if min(k, b, p, l) < 1:
        raise ValueError(f"need k, B, P, L >= 1 (got {k}, {b}, {p}, {l})")
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K} top slots per query")
    if b > 65535 * 32:
        raise ValueError(f"batch {b} exceeds the grid's y limit")
    if counters is not None:
        _launch.check("counters", counters, torch.int64, 1, dev)
        if counters.numel() != len(COUNT_FIELDS):
            raise ValueError(f"counters holds {counters.numel()} fields, not "
                             f"{len(COUNT_FIELDS)}")
    stages = ring_stages(l)
    items = _launch.aligned16(items)  # the bulk copies start on 16 bytes
    chunks, per = chunks_for(p, TILE_ITEMS, _launch.sm_count(dev.index or 0))
    part_s = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stride, m = sample_rows(p)
    samp = torch.empty((b, m), dtype=torch.float32, device=dev)
    amax = torch.empty((b, -(-m // _SAMPLE_ROWS)), dtype=torch.float32, device=dev)
    floor = torch.empty((b,), dtype=torch.float32, device=dev)
    args = (
        queries.data_ptr(), items.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), samp.data_ptr(), amax.data_ptr(), floor.data_ptr(),
        b, l, p, k, chunks, per, stages, m, stride,
        None if counters is None else counters.data_ptr(),
    )
    return library(), args, (items, part_s, part_i, out_s, out_i, samp, amax, floor)


def mips_topk_cuda(
    queries: torch.Tensor,  # [B, L] float32
    items: torch.Tensor,  # [P, L] float32
    k: int,
    counters: torch.Tensor | None = None,  # [len(COUNT_FIELDS)] int64, added into
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32) on the card;
    a row short of K items back-fills (-3e38, -1). K <= 256."""
    lib, args, bufs = _launch_args(queries, items, k, counters)
    err = lib.mips_topk_launch(*args, 7, _launch.stream(queries.device))
    _launch.raise_on_error(err, lib, "mips_topk_error_string", "mips_topk")
    mips_topk_cuda.launches += 1
    return bufs[3], bufs[4]


mips_topk_cuda.launches = 0
