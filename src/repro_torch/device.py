"""The device rule of the port's entry points.

An entry point (the serving route, the planner, `build_ivf`, the CLI)
takes ``device=`` and defaults to ``"cuda"``. When CUDA is missing it
raises; it never falls back to the CPU quietly. A caller that wants the
CPU (the parity tests) asks for ``"cpu"``.

Matmuls run in full fp32: `resolve_device` pins TF32 off for both cuBLAS
and cuDNN, because TF32 keeps about three decimal digits and the port is
held to the reference at 1e-5.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default "cuda") as a `torch.device`; raises
    RuntimeError for a CUDA device when CUDA is not available."""
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    # full fp32 matmuls (see the module docstring)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
