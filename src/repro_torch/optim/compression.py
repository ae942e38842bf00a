"""int8 gradient compression for the data-parallel all-reduce (the
reference's `repro/optim/compression.py`).

Pattern: quantise each gradient leaf to int8 with one per-tensor scale,
all-reduce, dequantise with the ranks' mean scale; error feedback keeps
what the quantisation lost for the next step. The arithmetic is the
reference's: ``scale = max|x| / 127 + 1e-12``, ``q = clip(round(x /
scale), -127, 127)`` (round half to even in both), the sum taken over
``q`` as int32 (exact up to 2^24 ranks).

What goes over the wire: the sum of int8 values overflows int8, so the
all-reduce carries ``q`` as int32, 4 bytes an element as a plain fp32
all-reduce of the same leaf, plus one fp32 scalar all-reduce of the
scales a leaf. As written (here and in the reference) it therefore cuts
no bytes; it bounds each rank's contribution to 8 bits of precision.
Every collective goes through `repro_torch.dist.collectives.all_reduce`,
so `collectives.STATS` counts its calls, bytes and host seconds
("compressed_q" and "compressed_scale").
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import all_reduce
from repro_torch.optim.optimizers import tree_map

__all__ = [
    "compressed_all_reduce",
    "dequantize_int8",
    "error_feedback_compress",
    "quantize_int8",
]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 0-dim) with x ~ q * scale."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_all_reduce(grads: Any, group=None) -> Any:
    """The sum of ``grads`` over ``group``'s ranks, through int8 (the
    reference's `compressed_psum`): each rank quantises each leaf, the
    int32 sum of the ``q`` is scaled by the mean of the ranks' scales.
    Every rank of ``group`` calls it with a tree of the same structure."""
    n = dist.get_world_size(group)

    def one(g):
        q, scale = quantize_int8(g)
        q_sum = all_reduce(q.to(torch.int32), group=group, name="compressed_q")
        # each rank used its own scale; the mean scale reconstructs
        scale_sum = all_reduce(scale, group=group, name="compressed_scale")
        return q_sum.to(torch.float32) * (scale_sum / n)

    return tree_map(one, grads)


def error_feedback_compress(grads: Any, residual: Any) -> tuple[Any, Any]:
    """1-bit-SGD-style error feedback: compress (g + e), keep the new
    residual. Returns (a tree of (q, scale) pairs shaped like ``grads``,
    the new residual)."""
    x = tree_map(torch.add, grads, residual)
    qs = tree_map(quantize_int8, x)
    return qs, tree_map(lambda xi, qi: xi - dequantize_int8(*qi), x, qs)
