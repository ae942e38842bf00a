"""Public wrappers of the flash-attention kernels, over the model's
[B, S, H, D] layout with grouped KV heads ([B, S, KV, D]).

`flash_attention` is a `torch.autograd.Function` (the reference's
`ops.flash_attention` is a `jax.custom_vjp`): its forward is the forward
kernel (the reference's `flash_attention_pallas`, K9) and saves q, k, v,
the output and the per-row logsumexp; its backward is the backward
kernel (`flash_backward_pallas`, K10), fed D = rowsum(dO * O).
`flash_attention_fwd` returns the logsumexp beside the output;
`flash_attention_bwd` returns (dq, dk, dv).

Dispatch is by the device of the tensors. On the CPU it is the plain
PyTorch versions (`ref.py`) over [B*H, S, D], with the KV heads
repeated; the backward then sums dk and dv over each group in the
inputs' dtype, as the transpose of the reference's `jnp.repeat` does. On
CUDA it is the hand-written kernels, or an error, with no fallback from
a kernel to a plain version. The kernels mask ragged sequence ends and
read each KV head in place, so on the card nothing is repeated, padded,
transposed or copied, and the backward's group sum is taken in fp32
inside the kernel (the same function in fp32; in bf16 it differs from
the reference's bf16 sum by that rounding). The reference's
``tile_q``/``tile_kv`` have no counterpart: its Pallas grid needs the
sequence padded to whole tiles, while neither the kernels nor the plain
versions do, and the result does not depend on the tiling.

Both kernels are registered operators, ``torch.ops.repro_torch.
flash_attention_fwd`` and ``flash_attention_bwd``
(`torch.library.custom_op`), which is how a trace that never runs them
sees them whole:

* their fake implementations give the outputs' shapes and dtypes, so a
  fake or meta tensor reaches neither ctypes nor a plain version;
* `launch.jaxpr_cost` costs them by `kernel.attention_work`, the
  arithmetic the kernels' bounds in `chip_smoke.py` use too;
* their DTensor sharding rules accept a replicated call, the batch
  sharded over any mesh dimension, and the heads sharded over a mesh
  dimension whose size divides the KV heads. `flash_attention` with
  DTensor inputs first lays q, k and v out as the reference's
  `shard_map` does (`repro/models/lm.py:_self_attention`): heads over
  ``model`` when they divide it, else (B * H) folded and sharded over
  ``flash_axes + ("model",)``, then over ``flash_axes``; grouped KV heads
  are repeated first.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_fwd"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _check_rows_live(sq: int, seq_kv: int, window: int | None, q_offset: int) -> None:
    """Every query row must see a live key: a row with none would come
    out as the mean of whatever keys the tiles cover, which depends on
    the tiling (the kernel skips tiles with no live key)."""
    last = q_offset + sq - 1
    if seq_kv < 1 or (window is not None and last - window + 1 > seq_kv - 1):
        raise ValueError(
            f"query rows up to position {last} see no live key (seq_kv {seq_kv}, "
            f"window {window})"
        )


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int | None, logit_cap: float | None,
            q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K9 on the card, its plain version on the CPU."""
    b, sq, h, dh = q.shape
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    if _on_cuda(q):
        return _kernel.flash_attention_fwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), **kw
        )
    n_rep = h // k.shape[2]
    out, lse = _ref.flash_attention_ref(_fold(q, 1), _fold(k, n_rep), _fold(v, n_rep), **kw)
    # contiguous, as the kernel's outputs and the fake implementation's
    return out.reshape(b, h, sq, dh).transpose(1, 2).contiguous(), lse.reshape(b, h, sq)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, window, logit_cap, q_offset):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
            lse: torch.Tensor, dsum: torch.Tensor, causal: bool, window: int | None,
            logit_cap: float | None,
            q_offset: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10 on the card, its plain version on the CPU."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    if _on_cuda(q):
        return _kernel.flash_attention_bwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.contiguous(), dsum.contiguous(), **kw,
        )
    n_rep = h // kvh
    dq, dk, dv = _ref.flash_attention_bwd_ref(
        _fold(q, 1), _fold(k, n_rep), _fold(v, n_rep), _fold(do, 1),
        lse.reshape(b * h, sq), dsum.reshape(b * h, sq), **kw,
    )

    def unfold_kv(x):  # the repeat's transpose: a group sum in x's dtype
        return x.reshape(b, kvh, n_rep, skv, dh).sum(dim=2).transpose(1, 2).contiguous()

    return dq.reshape(b, h, sq, dh).transpose(1, 2).contiguous(), unfold_kv(dk), unfold_kv(dv)


@_bwd_op.register_fake
def _bwd_fake(q, k, v, do, lse, dsum, causal, window, logit_cap, q_offset):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _fold(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, heads, D] -> [B * heads * n_rep, S, D], each head repeated
    n_rep times (the reference's `jnp.repeat` of the KV heads)."""
    b, s, n, d = x.shape
    return x.transpose(1, 2).repeat_interleave(n_rep, dim=1).reshape(b * n * n_rep, s, d)


def flash_attention_fwd(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] float32)."""
    _check_rows_live(q.shape[1], k.shape[1], window, q_offset)
    return _fwd_op(q, k, v, causal, window, logit_cap, q_offset)


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    out: torch.Tensor,  # [B, Sq, H, D], the forward's output
    lse: torch.Tensor,  # [B, H, Sq] float32, the forward's logsumexp
    do: torch.Tensor,  # [B, Sq, H, D], the output's cotangent
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes. D = rowsum(dO * O) is a
    torch reduction in fp32 here, as the reference takes it outside its
    Pallas body."""
    dsum = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [B, H, Sq]
    return _bwd_op(q, k, v, do, lse, dsum, causal, window, logit_cap, q_offset)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, logit_cap, q_offset = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)


def _backward(ctx, grad_out, grad_lse):
    del grad_lse  # the logsumexp is an output for the backward, not for the loss
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out, **ctx.kw)
    return dq, dk, dv, None, None, None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
    flash_axes: tuple = (),
) -> torch.Tensor:
    """Attention over [B, S, H, D] with GQA, the reference's
    `ops.flash_attention`: out [B, Sq, H, D] in q's dtype. DTensor inputs
    are laid out over ``flash_axes`` (the mesh's batch axes) and
    ``model`` first, as the reference's `shard_map`; plain tensors ignore
    ``flash_axes``."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _sharded(q, k, v, kw, tuple(flash_axes))
    return flash_attention_fwd(q, k, v, **kw)[0]


def _sharded(q, k, v, kw: dict, flash_axes: tuple):
    """The reference's layout of the kernel's inputs on the mesh
    (`repro/models/lm.py:_self_attention`), with the mesh's own sizes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import mesh_axes

    _register_sharding_rules()
    mesh = q.device_mesh
    held = mesh_axes(mesh)
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    if n_rep > 1:  # repeat before sharding, so a shard's heads keep their KV heads
        k, v = k.repeat_interleave(n_rep, dim=2), v.repeat_interleave(n_rep, dim=2)

    def size(axes):  # ranks over the mesh dims that ``axes`` hold
        return math.prod(n for n, ax in zip(mesh.shape, held) if set(ax) <= set(axes))

    def lay_out(x, axes, heads_dim=None):
        """dim 0 sharded over ``axes``, the heads over ``model``."""
        return x.redistribute(mesh, [
            Shard(0) if set(ax) <= set(axes) else
            Shard(heads_dim) if ax == ("model",) and heads_dim else Replicate()
            for ax in held])

    if flash_axes and h % size(("model",)) == 0:
        q, k, v = (lay_out(x, flash_axes, 2) for x in (q, k, v))
        return flash_attention_fwd(q, k, v, **kw)[0]
    axes = None
    if flash_axes:
        for cand in (flash_axes + ("model",), flash_axes):
            if b * h % size(cand) == 0:
                axes = cand
                break

    def fold(x):  # [B, S, H, D] -> [B * H, S, 1, D]
        x = x.transpose(1, 2).reshape(b * h, s, 1, d)
        return x if axes is None else lay_out(x, axes)

    out = flash_attention_fwd(fold(q), fold(k), fold(v), **kw)[0]
    # unfold from rows sharded over whole batch rows only (DTensor cannot
    # split a dim sharded over two mesh dims back into (B, H))
    batch_axes = flash_axes if b % size(flash_axes) == 0 else ()
    return lay_out(out, batch_axes).reshape(b, h, s, d).transpose(1, 2)


def _sharding_strategies(kv_heads: int, mesh, n_out: int, n_in: int, lse_out: tuple,
                         lse_in: tuple) -> list:
    """The kernels' acceptable placements on one mesh dimension: all
    replicated, the batch (dim 0 of every tensor) sharded, or the heads
    sharded (dim 2 of the [B, S, heads, D] tensors, dim 1 of the [B, H,
    Sq] ones) where every mesh dimension's size divides the KV heads, so
    that a shard's query heads keep their KV heads."""
    from torch.distributed.tensor import Replicate, Shard

    n_static = 4
    out = [([Replicate()] * n_out, [Replicate()] * n_in + [None] * n_static),
           ([Shard(0)] * n_out, [Shard(0)] * n_in + [None] * n_static)]
    if all(kv_heads % s == 0 for s in mesh.shape):
        out.append(([Shard(1) if i in lse_out else Shard(2) for i in range(n_out)],
                    [Shard(1) if i in lse_in else Shard(2) for i in range(n_in)]
                    + [None] * n_static))
    return out


def _register_sharding_rules() -> None:
    """Register the two kernels' DTensor sharding rules, once (the first
    time DTensors reach the kernels)."""
    if _RULES:
        return
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
    def _fwd_rule(q, k, v, causal, window, logit_cap, q_offset):
        return _sharding_strategies(k.shape[2], q.mesh, 2, 3, (1,), ())

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _bwd_rule(q, k, v, do, lse, dsum, causal, window, logit_cap, q_offset):
        return _sharding_strategies(k.shape[2], q.mesh, 3, 6, (), (4, 5))

    _RULES.append(True)


_RULES: list = []
