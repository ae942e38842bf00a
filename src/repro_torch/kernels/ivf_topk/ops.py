"""Public wrapper of the IVF query kernel.

`ivf_topk(queries, index, k)` keeps the reference wrapper's split
(`repro/kernels/ivf_topk/ops.py`): stage 1, the centroid scores and the
per-row top-n_probe, is a plain matmul and `torch.topk`, as it runs
outside the Pallas kernel in the reference too; stage 2 is the kernel,
run once over the main lists and, when ``delta`` is given, once more
over the delta buffers with the same probe ids; `merge_topk` merges the
two passes.

Stage 2 is a registered operator, ``torch.ops.repro_torch.
ivf_probe_topk`` (`kernels/_library.py`), over tensors: the queries,
the probe ids and one padded-list table, (scores, ids) out. Its body
dispatches by the device of the tensors: on the CPU the plain PyTorch
version (`ref.py`); on CUDA the hand-written kernel, or an error. There
is no fallback from the kernel to the plain version. A meta or fake
tensor reaches the fake implementation, and the op walker costs a call
by `kernel.ivf_probe_work`.

While a tracer is active (`repro_torch.obs.trace`), `ivf_topk` counts
from the very probe ids stage 2 is handed: the queries
(``ivf_topk.queries``, on the host) and, on the device, the tracer's
``ivf_topk.rows`` buffer (`ROW_FIELDS`): the live rows of the lists
each query probes, summed over the queries, and the live rows of the
union of the batch's probed lists (a scatter mask: no `unique`, no
sync), for the main lists and for the delta pass. Nothing is read back.
Both passes are counted in one go, and each table's live rows a list
are kept until the table changes: nine small ops a batch, whose
launches are most of the cost (a host that launches each batch's ops in
about the device's time feels them).
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.kernels import _library
from repro_torch.kernels.ivf_topk import kernel as _kernel
from repro_torch.kernels.ivf_topk import ref as _ref
from repro_torch.mips.exact import TopK, merge_topk
from repro_torch.mips.ivf import DEFAULT_N_PROBE, IVFIndex, resolve_cap_tile
from repro_torch.obs import trace as _trace

__all__ = ["ROW_FIELDS", "ivf_topk", "tile_align_index"]

# the fields of the ``ivf_topk.rows`` counters
ROW_FIELDS = ("probed_rows", "union_rows", "delta_probed_rows", "delta_union_rows")

_LIVE = WeakTensorKeyDictionary()  # a list table -> (its version, its live rows a list)


def tile_align_index(index: IVFIndex, cap_tile: int | None) -> tuple[IVFIndex, int]:
    """Resolve the cap tile against an index and pad its list axis up to
    a tile multiple once, exactly as the reference does. Returns
    (aligned index, CT). The Hopper kernel masks a ragged list end
    itself, so here the tile only fixes the layout (the same capacity as
    the reference's)."""
    capp = index.lists.shape[-1]
    ct = resolve_cap_tile(cap_tile, capp)
    pad = (-capp) % ct
    if pad:
        index = index._replace(
            lists=torch.nn.functional.pad(index.lists, (0, pad), value=-1),
            list_embs=torch.nn.functional.pad(index.list_embs, (0, 0, 0, pad)),
        )
    return index, ct


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _body(queries, probe, lists, list_embs, k):
    if _on_cuda(queries):
        return _kernel.ivf_probe_topk_cuda(queries, probe, lists, list_embs, k)
    return _ref.ivf_probe_topk_ref(queries, probe, lists, list_embs, k)


def _fake(queries, probe, lists, list_embs, k):
    shape = (queries.shape[0], k)
    return (queries.new_empty(shape, dtype=torch.float32),
            queries.new_empty(shape, dtype=torch.int32))


_op = _library.define(
    "ivf_probe_topk(Tensor queries, Tensor probe, Tensor lists, Tensor list_embs, int k) "
    "-> (Tensor, Tensor)", _body, _fake)


def _probe_lists(q, probe, lists, list_embs, k):
    """Stage 2 over one padded-list table (main or delta)."""
    return _op(q, probe, lists, list_embs.detach(), k)


def _live_rows(lists: torch.Tensor) -> torch.Tensor:
    """[C] int64: the live slots of each list of ``lists``, counted again
    only once the table has changed (its version counter moved)."""
    try:
        version = lists._version
    except RuntimeError:  # an inference tensor keeps no version: count every time
        return (lists >= 0).sum(dim=1)
    kept = _LIVE.get(lists)
    if kept is None or kept[0] != version:
        kept = _LIVE[lists] = (version, (lists >= 0).sum(dim=1))
    return kept[1]


def _count_rows(tracer, probe, tables) -> None:
    """The live rows ``probe`` (int64) reads in each of ``tables`` (the
    main lists and, where given, the delta lists): each query's lists
    summed over the queries, then the union of the batch's lists, added
    to the tracer's ``ivf_topk.rows`` in `ROW_FIELDS` order."""
    live = torch.stack([_live_rows(t) for t in tables])  # [tables, C]
    hit = torch.zeros_like(live[0]).index_fill_(0, probe.flatten(), 1)
    rows = torch.stack([live[:, probe].sum(dim=(1, 2)), (live * hit).sum(dim=1)], dim=1)
    buf = tracer.device_counters("ivf_topk.rows", len(ROW_FIELDS), live.device)
    buf[:rows.numel()] += rows.flatten()


def ivf_topk(
    queries: torch.Tensor,  # [B, L]
    index: IVFIndex,
    k: int,
    *,
    n_probe: int = DEFAULT_N_PROBE,
    delta: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> TopK:
    """queries [B, L] -> approximate TopK([B, K]) over `index`.

    ``delta`` is an optional (delta_lists [C, dcap], delta_embs
    [C, dcap, L]) pair, the append buffers of
    `repro_torch.mips.refresh.RefreshState.delta()`, probed with the
    same probe ids as the main lists and merged into the result."""
    n_probe = min(n_probe, index.lists.shape[0])
    q = queries.detach().float().contiguous()
    c_scores = q @ index.centroids.float().T  # [B, C]
    probe64 = torch.topk(c_scores, n_probe, dim=1).indices
    probe = probe64.to(torch.int32)
    tracer = _trace.current()
    if tracer is not None:
        tracer.count("ivf_topk.queries", q.shape[0])
        _count_rows(tracer, probe64, (index.lists,) if delta is None else (index.lists, delta[0]))
    scores, ids = _probe_lists(q, probe, index.lists, index.list_embs, k)
    if delta is None:
        return TopK(scores=scores, indices=ids)
    d_scores, d_ids = _probe_lists(q, probe, delta[0], delta[1], k)
    return merge_topk(
        torch.cat([scores, d_scores], dim=1), torch.cat([ids, d_ids], dim=1), k
    )
