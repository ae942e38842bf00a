"""Public wrapper of the exact top-K MIPS kernel (the retriever="pallas"
route).

The kernel is a registered operator, ``torch.ops.repro_torch.mips_topk``
(`kernels/_library.py`): one op over the kernel's floor, probe and
merge launches, (scores, ids) out. Its body dispatches by the device of
the tensors: on the CPU the plain PyTorch version (`ref.py`); on CUDA
the hand-written kernel, or an error. There is no fallback from the
kernel to the plain version. A meta or fake tensor reaches the fake
implementation, and the op walker costs a call by
`kernel.mips_topk_work`. The reference wrapper pads the batch and the catalog to its tiles on every
call; the Hopper kernel masks both ragged ends itself, so nothing is
padded or copied here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _library
from repro_torch.kernels.mips_topk import kernel as _kernel
from repro_torch.kernels.mips_topk import ref as _ref
from repro_torch.mips.exact import TopK

__all__ = ["mips_topk"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _body(queries, items, k):
    if _on_cuda(queries):
        return _kernel.mips_topk_cuda(queries, items, k)
    scores, ids = _ref.mips_topk_ref(queries, items, k)
    # the streamed merge's result may be a view of its last block's sort
    return scores.contiguous(), ids.contiguous()


def _fake(queries, items, k):
    shape = (queries.shape[0], k)
    return (queries.new_empty(shape, dtype=torch.float32),
            queries.new_empty(shape, dtype=torch.int32))


_op = _library.define("mips_topk(Tensor queries, Tensor items, int k) -> (Tensor, Tensor)",
                      _body, _fake)


def mips_topk(queries: torch.Tensor, items: torch.Tensor, k: int) -> TopK:
    """queries [B, L], items [P, L] -> exact TopK([B, K]), sorted."""
    scores, ids = _op(queries.detach().float().contiguous(),
                      items.detach().float().contiguous(), k)
    return TopK(scores=scores, indices=ids)
