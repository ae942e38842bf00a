"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W power limit), and the least time a piece of work can take.

Every product of fp32 operands is priced at the TF32 tensor-core rate,
the fastest at which the chip multiplies fp32 operands, so no
fp32-accurate path (3xTF32 included) can read past it."""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "TF32_FLOPS", "bound_s"]

TF32_FLOPS = 495e12  # fp32 operands, TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # 80 GB HBM3


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "flops"): the larger of the bytes over the
    memory's peak and the FLOPs over the fp32 product peak."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / TF32_FLOPS
    return (t_b, "bytes") if t_b >= t_f else (t_f, "flops")
