"""Public wrapper of the exact top-K MIPS kernel (the retriever="pallas"
route).

Dispatch is by the device of the tensors: on the CPU it is the plain
PyTorch version (`ref.py`); on CUDA it is the hand-written kernel, or an
error. There is no fallback from the kernel to the plain version. The
reference wrapper pads the batch and the catalog to its tiles on every
call; the Hopper kernel masks both ragged ends itself, so nothing is
padded or copied here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mips_topk import kernel as _kernel
from repro_torch.kernels.mips_topk import ref as _ref
from repro_torch.mips.exact import TopK

__all__ = ["mips_topk"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def mips_topk(queries: torch.Tensor, items: torch.Tensor, k: int) -> TopK:
    """queries [B, L], items [P, L] -> exact TopK([B, K]), sorted."""
    q = queries.float().contiguous()
    it = items.float().contiguous()
    if _on_cuda(q):
        scores, ids = _kernel.mips_topk_cuda(q, it, k)
    else:
        scores, ids = _ref.mips_topk_ref(q, it, k)
    return TopK(scores=scores, indices=ids)
