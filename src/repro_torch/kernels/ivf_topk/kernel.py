"""The Hopper IVF top-K kernel (`csrc/ivf_topk.cu`), bound with ctypes.

`ivf_probe_topk_cuda` computes what the reference's `ivf_topk_pallas`
computes: the masked top-K over the probed clusters' padded inverted
lists, without materialising the candidate tensor. See the source for
the design and its bound.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs and the partial top-K scratch with `torch.empty`, launches on
PyTorch's current stream without synchronising, and raises if the
launch is refused. It counts its launches in
``ivf_probe_topk_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["SOURCE", "ivf_probe_topk_cuda", "library", "splits_for"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ivf_topk.cu"

# H100 SXM: 132 SMs; aim for two blocks each on the probe kernel
_TARGET_BLOCKS = 2 * 132
_MAX_SMEM = 232_448  # the most dynamic shared memory a Hopper block can use


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "ivf_topk_launch", "p" * 8 + "i" * 7 + "p")
    _launch.declare(lib, "ivf_topk_smem_bytes", "iii", ctypes.c_size_t)
    _launch.declare(lib, "ivf_topk_threads", "")
    _launch.declare(lib, "ivf_topk_error_string", "i", ctypes.c_char_p)
    return lib


@functools.cache
def _launch_shape(l: int, k: int) -> int:
    """The kernel's tile width, after checking that (L, K) fit the shared
    memory of a Hopper block (K is never capped silently)."""
    lib = library()
    for which in (0, 1):
        smem = lib.ivf_topk_smem_bytes(l, k, which)
        if smem > _MAX_SMEM:
            raise ValueError(
                f"k={k}, L={l} need {smem} bytes of shared memory per block, "
                f"more than the {_MAX_SMEM} a Hopper block can use"
            )
    return lib.ivf_topk_threads()


def splits_for(
    batch: int, n_probe: int, capp: int, k: int, tile: int
) -> tuple[int, int]:
    """(splits, chunk): each probed list is cut into `splits` chunks of
    `chunk` slots (a multiple of the kernel's tile). More splits give the
    probe kernel more blocks (up to `_TARGET_BLOCKS`, to fill the card at a
    small batch) but give the merge kernel, one block per row, n_probe *
    splits * K candidates to fold. Balancing a probe block's capp / splits
    slots against the merge's n_probe * splits * K puts splits near
    sqrt(capp / (n_probe * K)): 4 at the serving shape (capp 2048,
    n_probe 8, K 10), 1 at K 256."""
    tiles = max(1, -(-capp // tile))
    fill = -(-_TARGET_BLOCKS // max(1, batch * n_probe))
    balance = math.isqrt(max(1, capp // max(1, n_probe * k)))
    want = max(1, min(fill, balance, tiles))
    chunk = -(-tiles // want) * tile
    return -(-capp // chunk), chunk


def ivf_probe_topk_cuda(
    queries: torch.Tensor,  # [B, L] float32
    probe: torch.Tensor,  # [B, n_probe] int32 cluster ids
    lists: torch.Tensor,  # [C, capp] int32 item ids, -1 padded
    list_embs: torch.Tensor,  # [C, capp, L] float32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32) on the card."""
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
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's y limit 65535")
    tile = _launch_shape(l, k)
    splits, chunk = splits_for(b, n_probe, capp, k, tile)
    part_s = torch.empty((b, n_probe * splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_probe * splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    err = library().ivf_topk_launch(
        queries.data_ptr(), probe.data_ptr(), lists.data_ptr(),
        list_embs.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        b, l, n_probe, capp, k, splits, chunk, _launch.stream(dev),
    )
    _launch.raise_on_error(err, library(), "ivf_topk_error_string", "ivf_topk")
    ivf_probe_topk_cuda.launches += 1
    return out_s, out_i


ivf_probe_topk_cuda.launches = 0
