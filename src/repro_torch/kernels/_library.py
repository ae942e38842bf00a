"""The port's operator library for K1-K8: one `torch.library.Library`
fragment of the ``repro_torch`` namespace, on which each kernel's
`ops.py` defines its operator.

`define` gives an operator its schema, one Python body under both the
CPU and the CUDA dispatch keys (the body picks the kernel or the plain
version by the tensor's device, as the wrappers always did), and a fake
implementation, which a meta or fake tensor reaches instead of ctypes or
a plain version. A trace then sees the kernel whole: `launch.jaxpr_cost`
costs it by its rule in `KERNEL_RULES`.

`Library.define` + `impl` costs less host time a call than
`torch.library.custom_op` (no autograd wrapper, no schema inference at
call time), which the host-bound training step feels; K9 and K10, whose
calls are few and long, stay `custom_op`s with autograd and DTensor
rules (`kernels/flash_attention/ops.py`). None of K1-K8 has an autograd
formula: the wrappers pass detached tensors, so their outputs are
constants on every device, as the kernels' outputs are; the covgrad
step differentiates through its own `autograd.Function`.
"""
from __future__ import annotations

import torch

__all__ = ["LIB", "define"]

LIB = torch.library.Library("repro_torch", "FRAGMENT")


def define(schema: str, body, fake) -> torch._ops.OpOverload:
    """Define ``repro_torch::<name>`` from ``schema``, with ``body`` under
    the CPU and CUDA keys and ``fake`` for meta and fake tensors; returns
    the operator's default overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, body, "CPU")
    LIB.impl(name, body, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    return getattr(torch.ops.repro_torch, name).default
