"""The op cost walker: global FLOPs and bytes of one step, counted op by
op as the step runs (the counterpart of the reference's
`repro/launch/jaxpr_cost.py`, which walks a jaxpr; this module keeps its
path, and walks aten ops).

`OpCost` is a `TorchDispatchMode`. Over a program on DTensors it costs
every op at the DTensor level, where the shapes are the global ones:
each op once, for the whole mesh, as the reference's walker counts the
logical program (`torch.utils.flop_counter.FlopCounterMode` counts
DTensors' FLOPs the same way). What DTensor runs underneath, the local
ops on each rank's shard and the collectives between them, it does not
cost; it records there the collectives one rank issues and the memory
one rank holds (`OpCost.collectives`, `OpCost.memory`). An op on plain
tensors is costed once, where it runs.

The rules are the reference's (`jaxpr_cost.py:160-215`):

  * a product (mm, addmm, bmm, baddbmm) costs 2 M N K batch FLOPs and
    reads its operands and writes its output;
  * an elementwise op costs 1 FLOP an element and no bytes (fused into
    its producers and consumers), and so does an op no rule names;
  * views, layout changes, copies of a whole tensor, creation,
    comparisons and concatenation cost nothing;
  * a materialising op (gather, index, scatter, reduce, sort / top-K,
    cumulative) reads its inputs and writes its outputs; a reduction
    also costs an element of its input a FLOP (the reference's
    in_bytes / 4);
  * an in-place slice update (`copy_` into a view) costs 2 x the update
    (read-modify-write of the touched region);
  * a kernel op (namespace ``repro_torch``: K1-K10, each a registered
    operator with a fake implementation) costs what its rule in
    `KERNEL_RULES` says, its kernel's work function (`kernel.py`) at the
    shape-only upper end; one with no rule raises. Nothing costs a
    kernel's plain version in its place, on any device, meta included.
    The reference's `pallas_call` rule charges every BlockSpec block once
    per grid step instead, which counts a tiled kernel's whole resident
    block again at every step (the [P, L] beta of its SNIS kernels): a
    TPU artefact the Hopper kernels do not share.

`analyze` adds the program's I/O once (arguments read, outputs written).
The count is of what the step runs: the port's layers run in Python
loops, so a trace is unrolled; `launch.dryrun` extrapolates along the
loops instead where that is quicker.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch import costs

__all__ = ["KERNEL_RULES", "OpCost", "analyze", "nbytes", "phase"]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}

_ZERO_COST = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "slice",
    "select", "squeeze", "unsqueeze", "alias", "detach", "as_strided", "clone",
    "_to_copy", "contiguous", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones", "ones_like",
    "new_ones", "full", "full_like", "new_full", "arange", "scalar_tensor", "lift_fresh",
    "lift_fresh_copy", "cat", "stack", "split", "split_with_sizes", "chunk", "unbind",
    "constant_pad_nd", "eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isinf", "isnan",
    "repeat_interleave", "repeat", "flip", "fill", "fill_", "zero_", "zero",
    "_local_scalar_dense", "diagonal", "narrow", "unfold", "view_as_real", "expand_as",
    "_unsafe_index", "_reshape_alias", "unsqueeze_", "squeeze_", "transpose_", "t_",
    "slice_scatter", "select_scatter", "detach_", "resize_", "set_",
}

_MATERIALIZING = {
    "index_select", "gather", "embedding", "index", "index_add", "index_add_",
    "index_put", "index_put_", "_index_put_impl_", "index_copy", "index_copy_",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "sort", "topk", "argmax", "argmin", "cumsum", "cumprod",
    "cummax", "cummin", "logcumsumexp", "sum", "mean", "amax", "amin", "max", "min",
    "prod", "any", "all", "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "var", "var_mean", "std", "norm", "linalg_vector_norm",
    "embedding_dense_backward", "nll_loss_forward", "nll_loss_backward",
    "masked_select", "nonzero", "unique", "_unique2", "bincount", "searchsorted",
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "logsumexp",
    "var", "var_mean", "std", "norm", "linalg_vector_norm", "_softmax", "_log_softmax",
}

def _flash_fwd_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.flash_attention.kernel import attention_work

    q, k, _, causal, window, _, q_offset = args
    b, sq, h, d = q.shape
    flops, products, nb = attention_work(b, sq, k.shape[1], h, k.shape[2], d,
                                         q.element_size(), causal, window, q_offset)
    return flops * products, nb


def _flash_bwd_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.flash_attention.kernel import attention_work

    q, k, _, _, _, _, causal, window, _, q_offset = args
    b, sq, h, d = q.shape
    flops, products, nb = attention_work(b, sq, k.shape[1], h, k.shape[2], d,
                                         q.element_size(), causal, window, q_offset,
                                         backward=True)
    return flops * products, nb


def _covgrad_fwd_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.snis_covgrad.kernel import snis_fwd_work

    h, beta, actions, _, _, covgrad = args
    flops, products, nb = snis_fwd_work(h.shape[0], actions.shape[1], h.shape[1],
                                        beta.shape[0], covgrad)
    return flops * products, nb


def _covgrad_bwd_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.snis_covgrad.kernel import snis_bwd_work

    coeff, _, beta = args
    (b, s), (p, l) = coeff.shape, beta.shape
    flops, products, nb = snis_bwd_work(b, s, l, p)
    return flops * products, nb


def _sampler_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.fused_sampler.kernel import sampler_work

    _, _, ids, _, num_samples, _, sample_tile, _ = args
    b, k = ids.shape
    flops, products, nb = sampler_work(b, num_samples, -(-num_samples // sample_tile)
                                       * sample_tile, k)
    return flops * products, nb


def _mips_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.mips_topk.kernel import mips_topk_work

    queries, items, k = args[:3]  # and the optional counters, which cost nothing
    flops, products, nb = mips_topk_work(queries.shape[0], *items.shape, k)
    return flops * products, nb


def _ivf_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.ivf_topk.kernel import ivf_probe_work

    queries, probe, lists, _, k = args
    flops, products, nb = ivf_probe_work(*queries.shape, probe.shape[1], lists.shape[1], k)
    return flops * products, nb


def _embedding_bag_rule(args, out) -> tuple[int, int]:
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_work

    table, indices = args
    flops, products, nb = embedding_bag_work(*indices.shape, *table.shape,
                                             table.element_size())
    return flops * products, nb


# kernel op name -> rule(args, outputs) -> (flops, bytes), over global
# shapes: each kernel's work function (`kernel.py`) at the shape-only
# upper end (every action live and distinct, every list slot live,
# every bag id distinct), the arithmetic of its bound in `chip_smoke.py`
KERNEL_RULES = {
    "snis_covgrad_fwd": _covgrad_fwd_rule,
    "snis_covgrad_bwd": _covgrad_bwd_rule,
    "fused_sampler": _sampler_rule,
    "mips_topk": _mips_rule,
    "ivf_probe_topk": _ivf_rule,
    "embedding_bag": _embedding_bag_rule,
    "flash_attention_fwd": _flash_fwd_rule,
    "flash_attention_bwd": _flash_bwd_rule,
}


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _product_flops(name: str, args) -> int:
    if name == "mm":
        a, b = args[0], args[1]
    elif name == "addmm":
        a, b = args[1], args[2]
    elif name == "bmm":
        a, b = args[0], args[1]
    else:  # baddbmm
        a, b = args[1], args[2]
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2 * batch * m * b.shape[-1] * k


def op_cost(func, args, kwargs, out) -> tuple[int, int]:
    """(FLOPs, bytes) of one op by the rules above, from its arguments'
    and outputs' shapes (global shapes for DTensors)."""
    name = func._overloadpacket.__name__
    if func.namespace == "repro_torch":
        if name not in KERNEL_RULES:
            raise NotImplementedError(f"kernel op repro_torch::{name} has no cost rule")
        return KERNEL_RULES[name](args, out)
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if name in _PRODUCTS:
        flops = _product_flops(name, args)
        operands = args[:2] if name in ("mm", "bmm") else args[1:3]
        extra = math.prod(outs[0].shape) if name in ("addmm", "baddbmm") else 0
        return flops + extra, sum(nbytes(t) for t in operands) + sum(nbytes(t) for t in outs)
    if name in _ZERO_COST:
        return 0, 0
    if name == "copy_":  # an update of a region of its destination
        return 0, 2 * nbytes(args[1]) if isinstance(args[1], torch.Tensor) else 0
    if name in _MATERIALIZING:
        in_b, out_b = sum(nbytes(t) for t in ins), sum(nbytes(t) for t in outs)
        return (in_b // 4 if name in _REDUCTIONS else 0), in_b + out_b
    # elementwise, random, and ops no rule names: 1 FLOP an output element
    return sum(t.numel() for t in outs), 0


class _Memory:
    """The bytes of local tensors one rank holds, by storage: a storage is
    live from the op that makes it until its last tracked tensor dies.
    ``phase_peaks`` holds the peak of each phase of the step (`phase`)."""

    def __init__(self):
        self.live: dict[int, int] = {}  # storage key -> bytes
        self.refs: dict[int, int] = {}  # storage key -> tracked tensors
        self.current = 0
        self.peak = 0
        self.phase = "step"
        self.phase_peaks: dict[str, int] = {}

    @staticmethod
    def key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def track(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        k = self.key(t)
        if k not in self.live:
            self.live[k] = t.untyped_storage().nbytes()
            self.current += self.live[k]
            self.peak = max(self.peak, self.current)
            self.phase_peaks[self.phase] = max(self.phase_peaks.get(self.phase, 0),
                                               self.current)
        self.refs[k] = self.refs.get(k, 0) + 1
        weakref.finalize(t, self._release, k)

    def _release(self, k: int) -> None:
        self.refs[k] -= 1
        if not self.refs[k]:
            del self.refs[k]
            self.current -= self.live.pop(k)


class _Local(TorchDispatchMode):
    """The ops under a DTensor op: collectives and one rank's memory."""

    def __init__(self, owner: OpCost):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = func(*args, **(kwargs or {}))
        if not _in_sharding_propagation():
            self.owner._local(func, out)
        return out


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is running this op: it runs
    ops on global-shaped stand-ins (under a `FakeTensorMode`, or on the
    meta device through an op's decomposition) to learn the output's
    shape, which no rank allocates."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        return True
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


_PROPAGATION_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _bare(e: BaseException) -> BaseException:
    """``e`` and the exceptions it chains without their tracebacks, whose
    frames would hold an op's tensors in reference cycles until the next
    garbage collection (the memory count would then depend on when that
    runs)."""
    seen = e
    while seen is not None:
        seen.__traceback__ = None
        seen = seen.__cause__ or seen.__context__
    return e


def _reshard_call(func, args, kwargs):
    """``func`` on DTensors, its inputs resharded where DTensor cannot
    propagate their layout (a view that splits a sharded dim unevenly, as
    [B, S, H * Dh] -> [B, S, H, Dh] with 8 heads over 16 shards): the
    sharded mesh dims of the inputs are replicated one at a time, the
    last mesh dim first, until the op runs, as GSPMD reshards where a
    layout cannot pass an op. The redistributions are collectives like
    any other, so they are counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    try:
        return func(*args, **kwargs)
    except RuntimeError as e:  # the message differs between torch versions
        if not any(isinstance(a, DTensor) and any(isinstance(p, Shard) for p in a.placements)
                   for a in args):
            raise
        err = _bare(e)
    flat = list(args)
    last = None
    for i, a in enumerate(flat):
        if not isinstance(a, DTensor):
            continue
        pl = list(a.placements)
        for m in reversed(range(len(pl))):
            if not isinstance(pl[m], Shard):
                continue
            pl[m] = Replicate()
            try:
                # the local tensor made contiguous: a gathered shard's strides
                # may not take a view, while the DTensor reports contiguous
                r = a.redistribute(a.device_mesh, pl)
                flat[i] = DTensor.from_local(r.to_local().contiguous(), r.device_mesh,
                                             r.placements, run_check=False, shape=r.shape,
                                             stride=r.stride())
                return func(*flat, **kwargs)
            except RuntimeError as e:
                last = _bare(e)
    raise err from last


class OpCost(TorchDispatchMode):
    """Counts, while active: ``flops`` and ``bytes`` (global, by the rules
    above; ``product_flops`` the products' share of the FLOPs),
    ``collectives`` (one rank's: a list of (kind, result bytes)),
    ``memory`` (one rank's live local bytes: ``.current``, ``.peak``) and
    ``kernel_ops`` (kernel op name -> calls). An op whose DTensor layout
    cannot propagate is run on resharded inputs (`_reshard_call`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.product_flops = 0
        self.collectives: list[tuple[str, int]] = []
        self.memory = _Memory()
        self.kernel_ops: dict[str, int] = {}
        self._inner = _Local(self)

    def _cost(self, func, args, kwargs, out) -> None:
        f, b = op_cost(func, args, kwargs, out)
        self.flops += f
        self.bytes += b
        if func._overloadpacket.__name__ in _PRODUCTS:
            self.product_flops += _product_flops(func._overloadpacket.__name__, args)
        if func.namespace == "repro_torch":
            name = func._overloadpacket.__name__
            self.kernel_ops[name] = self.kernel_ops.get(name, 0) + 1

    def _local(self, func, out) -> None:
        kind = costs.collective_kind(func)
        if kind is not None:
            self.collectives.append((kind, sum(nbytes(t) for t in _tensors(out))))
        for t in _tensors(out):
            self.memory.track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            with self._inner:
                out = _reshard_call(func, args, kwargs)
            self._cost(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        self._cost(func, args, kwargs, out)
        self._local(func, out)
        return out


_ACTIVE: list[OpCost] = []


@contextlib.contextmanager
def phase(name: str):
    """Mark a phase of the step (the optimizer's update, say) for the
    active `OpCost`: its memory peak is kept apart, so that a step traced
    at two sizes gives each phase's peak its own extrapolation. A no-op
    when no `OpCost` is active."""
    if not _ACTIVE:
        yield
        return
    # the earlier phase's unreachable tensors (autograd graphs in reference
    # cycles) go now, not at some later collection
    gc.collect()
    mem = _ACTIVE[-1].memory
    before, mem.phase = mem.phase, name
    mem.phase_peaks[name] = max(mem.phase_peaks.get(name, 0), mem.current)
    try:
        yield
    finally:
        mem.phase = before


def _local_storages(tree) -> dict[int, int]:
    from torch.distributed.tensor import DTensor

    out = {}
    for t in _tensors(tree):
        t = t._local_tensor if isinstance(t, DTensor) else t
        out[_Memory.key(t)] = t.untyped_storage().nbytes()
    return out


def analyze(fn, *args) -> dict[str, Any]:
    """Run ``fn(*args)`` under `OpCost` and return its global ``flops`` and
    ``bytes`` (the program's I/O included once), ``product_flops``, one rank's
    ``collectives`` (kind, result bytes) and ``memory`` (argument,
    output, alias, temp and peak bytes of local storage, and the peak of
    each `phase`), the calls of
    each kernel op (``kernel_ops``) and the outputs (``out``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    arg_st = _local_storages(args)
    mode = OpCost()
    for k, n in arg_st.items():  # the arguments are live from the start
        mode.memory.live[k] = n
        mode.memory.refs[k] = 1
        mode.memory.current += n
    mode.memory.peak = mode.memory.current
    mode.memory.phase_peaks["step"] = mode.memory.current
    with contextlib.ExitStack() as stack:
        if any(isinstance(t, DTensor) for t in _tensors(args)):
            # the plain tensors a program makes (positions, masks) are
            # replicated over the mesh
            stack.enter_context(implicit_replication())
        stack.enter_context(mode)
        _ACTIVE.append(mode)
        stack.callback(_ACTIVE.pop)
        out = fn(*args)
    io = sum(nbytes(t) for t in _tensors(args)) + sum(nbytes(t) for t in _tensors(out))
    out_st = _local_storages(out)
    arg_b = sum(arg_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    memory = {
        "argument_bytes": arg_b,
        "output_bytes": sum(out_st.values()),
        "alias_bytes": alias,
        "temp_bytes": mode.memory.peak - arg_b,
        "peak_bytes": mode.memory.peak,
        "phase_peaks": dict(mode.memory.phase_peaks),
    }
    return {"flops": mode.flops, "bytes": mode.bytes + io,
            "product_flops": mode.product_flops, "collectives": mode.collectives,
            "memory": memory, "kernel_ops": dict(mode.kernel_ops), "out": out}
