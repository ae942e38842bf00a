"""The Hopper exact top-K MIPS kernel (`csrc/mips_topk.cu`), bound with
ctypes.

`mips_topk_cuda` computes what the reference's `mips_topk_pallas`
computes: the exact top-K of queries @ items.T over the whole catalog,
sorted descending, without storing the [B, P] score matrix. See the
source for the design and its bound.

The wrapper checks device, dtype, shape and contiguity, cuts the catalog
into about one chunk per SM, allocates the outputs and the partial
top-K scratch with `torch.empty`, launches on PyTorch's current stream
without synchronising, and raises if the launch is refused. It counts
its launches in ``mips_topk_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["SOURCE", "chunks_for", "library", "mips_topk_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "mips_topk.cu"

_MAX_SMEM = 232_448  # the most dynamic shared memory a Hopper block can use


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "mips_topk_launch", "pppppp" + "iiiiii" + "p")
    _launch.declare(lib, "mips_topk_smem_bytes", "iii", ctypes.c_size_t)
    _launch.declare(lib, "mips_topk_tile_items", "")
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


@functools.cache
def _tile_items(l: int, k: int) -> int:
    """The kernel's tile height, after checking that (L, K) fit the
    shared memory of a Hopper block (K is never capped silently)."""
    lib = library()
    for which in (0, 1):
        smem = lib.mips_topk_smem_bytes(l, k, which)
        if smem > _MAX_SMEM:
            raise ValueError(
                f"k={k}, L={l} need {smem} bytes of shared memory per block, "
                f"more than the {_MAX_SMEM} a Hopper block can use"
            )
    return lib.mips_topk_tile_items()


def mips_topk_cuda(
    queries: torch.Tensor,  # [B, L] float32
    items: torch.Tensor,  # [P, L] float32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32) on the card;
    a row short of K items back-fills (-3e38, -1)."""
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
    if b > 65535 * 32:
        raise ValueError(f"batch {b} exceeds the grid's y limit")
    tile = _tile_items(l, k)
    if l % 4 == 0:
        items = _launch.aligned16(items)
    chunks, per = chunks_for(p, tile, _launch.sm_count(dev.index or 0))
    part_s = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = library()
    err = lib.mips_topk_launch(
        queries.data_ptr(), items.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), b, l, p, k, chunks, per,
        _launch.stream(dev),
    )
    _launch.raise_on_error(err, lib, "mips_topk_error_string", "mips_topk")
    mips_topk_cuda.launches += 1
    return out_s, out_i


mips_topk_cuda.launches = 0
