"""The precision a reference computes its products in. "fp32" is the
configurations' stated precision (IEEE fp32 products, TF32 off);
"tf32" is the control, the nearest precision below: every operand of a
product rounded to TF32's 10-bit mantissa (to nearest, ties away from
zero) before an fp32 product, the same on the CPU and the card."""
from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "cast", "fp32_products"]

PRECISIONS = ("fp32", "tf32")


def cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product operand in ``precision``."""
    if precision == "fp32":
        return x
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp32_products() -> None:
    """IEEE fp32 matmuls: the card's TF32 off, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
