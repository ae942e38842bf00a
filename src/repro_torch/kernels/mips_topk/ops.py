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

While a tracer is active (`repro_torch.obs.trace`), `mips_topk` hands
the op the tracer's ``mips_topk`` buffer (`kernel.COUNT_FIELDS`): on
CUDA the probe kernel's counting instantiation adds its tiles, appends,
folds and cycles by phase into it; the CPU body counts the queries
alone. Without a tracer the op is called as it always was.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _library
from repro_torch.kernels.mips_topk import kernel as _kernel
from repro_torch.kernels.mips_topk import ref as _ref
from repro_torch.mips.exact import TopK
from repro_torch.obs import trace as _trace

__all__ = ["mips_topk"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _body(queries, items, k, counters=None):
    if _on_cuda(queries):
        return _kernel.mips_topk_cuda(queries, items, k, counters)
    if counters is not None:
        counters[0] += queries.shape[0]
    scores, ids = _ref.mips_topk_ref(queries, items, k)
    # the streamed merge's result may be a view of its last block's sort
    return scores.contiguous(), ids.contiguous()


def _fake(queries, items, k, counters=None):
    shape = (queries.shape[0], k)
    return (queries.new_empty(shape, dtype=torch.float32),
            queries.new_empty(shape, dtype=torch.int32))


_op = _library.define(
    "mips_topk(Tensor queries, Tensor items, int k, Tensor(a!)? counters=None) "
    "-> (Tensor, Tensor)", _body, _fake)


def mips_topk(queries: torch.Tensor, items: torch.Tensor, k: int) -> TopK:
    """queries [B, L], items [P, L] -> exact TopK([B, K]), sorted."""
    q, it = queries.detach().float().contiguous(), items.detach().float().contiguous()
    counters = _trace.device_counters("mips_topk", len(_kernel.COUNT_FIELDS), q.device)
    scores, ids = _op(q, it, k) if counters is None else _op(q, it, k, counters)
    return TopK(scores=scores, indices=ids)
