"""The Hopper in-kernel mixture sampler (`csrc/fused_sampler.cu`), bound
with ctypes.

`fused_sampler_cuda` computes what the reference's `fused_sampler_pallas`
computes, with the same splitmix32 integer stream. See the source for
the design and its bound.

The wrapper checks device, dtype, shape and contiguity, refuses a K
whose row and membership table (at most half full) exceed a block's
shared memory (the library's `fused_sampler_smem_bytes`: K <= 12590),
allocates the three [B, Sp] outputs with `torch.empty`, launches on
PyTorch's current stream without synchronising, and raises if the
launch is refused. eps stays on the card (a 0-d tensor): no host read.
It counts its launches in ``fused_sampler_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["SOURCE", "fused_sampler_cuda", "library", "sampler_work"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_sampler.cu"

_MAX_SMEM = 232_448  # a Hopper block's opt-in shared memory (kMaxSmem)


def _largest_k(lib: ctypes.CDLL) -> int:
    """The largest K whose row and table fit a block (the bytes grow with K)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if lib.fused_sampler_smem_bytes(mid) <= _MAX_SMEM else (lo, mid - 1)
    return lo


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "fused_sampler_launch", "ipi" + "ppppp" + "iiiii" + "p")
    _launch.declare(lib, "fused_sampler_smem_bytes", "i", ctypes.c_size_t)
    _launch.declare(lib, "fused_sampler_error_string", "i", ctypes.c_char_p)
    return lib


def sampler_work(b: int, s: int, sp: int, k: int,
                 kappa_draws: float | None = None) -> tuple[float, int, int]:
    """(Gumbel slots scored, 1, bytes) of one call: each of the
    ``kappa_draws`` draws on the top-K arm (by default every live one,
    B S) scores the K slots of its row; the top-K row (ids and scores)
    is read once and the three [B, Sp] outputs are written once. The
    card's bound counts the kernel's instructions instead (its SASS,
    `chip_smoke.py`)."""
    kappa_draws = b * s if kappa_draws is None else kappa_draws
    return kappa_draws * k, 1, b * k * 8 + b * sp * 12


def fused_sampler_cuda(
    seed: int,
    epsilon: torch.Tensor,  # 0-d float32 on the card
    topk_ids: torch.Tensor,  # [B, K] int32
    topk_scores: torch.Tensor,  # [B, K] float32
    *,
    num_samples: int,
    num_items: int,
    sample_tile: int,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(actions [B, Sp] int32, log_q [B, Sp] float32, topk_slot [B, Sp]
    int32), Sp = ceil(S / TS) * TS; positions >= S are dead slots."""
    dev = topk_ids.device
    if dev.type != "cuda":
        raise ValueError(f"fused_sampler_cuda takes CUDA tensors, got {dev}")
    _launch.check("topk_ids", topk_ids, torch.int32, 2, dev)
    _launch.check("topk_scores", topk_scores, torch.float32, 2, dev)
    _launch.check("epsilon", epsilon, torch.float32, 0, dev)
    b, k = topk_ids.shape
    if topk_scores.shape != (b, k):
        raise ValueError(
            f"shape mismatch: topk_ids {tuple(topk_ids.shape)}, topk_scores "
            f"{tuple(topk_scores.shape)}"
        )
    if min(b, k, num_samples, num_items, sample_tile) < 1:
        raise ValueError(
            f"need B, K, num_samples, num_items, sample_tile >= 1 (got {b}, {k}, "
            f"{num_samples}, {num_items}, {sample_tile})"
        )
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's y limit 65535")
    lib = library()
    if lib.fused_sampler_smem_bytes(k) > _MAX_SMEM:
        raise ValueError(f"k={k} does not fit the shared memory of a Hopper block (the row "
                         f"and a table at most half full: K <= {_largest_k(lib)})")
    sp = -(-num_samples // sample_tile) * sample_tile
    actions = torch.empty((b, sp), dtype=torch.int32, device=dev)
    log_q = torch.empty((b, sp), dtype=torch.float32, device=dev)
    slots = torch.empty((b, sp), dtype=torch.int32, device=dev)
    err = lib.fused_sampler_launch(
        int(seed), epsilon.data_ptr(), int(row_offset), topk_ids.data_ptr(),
        topk_scores.data_ptr(), actions.data_ptr(), log_q.data_ptr(),
        slots.data_ptr(), b, num_samples, sp, k, num_items, _launch.stream(dev),
    )
    _launch.raise_on_error(err, lib, "fused_sampler_error_string", "fused_sampler")
    fused_sampler_cuda.launches += 1
    return actions, log_q, slots


fused_sampler_cuda.launches = 0
