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
"""
from __future__ import annotations

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
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    _check_rows_live(sq, skv, window, q_offset)
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    if _on_cuda(q):
        return _kernel.flash_attention_fwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), **kw
        )
    n_rep = h // kvh
    out, lse = _ref.flash_attention_ref(_fold(q, 1), _fold(k, n_rep), _fold(v, n_rep), **kw)
    return out.reshape(b, h, sq, dh).transpose(1, 2), lse.reshape(b, h, sq)


def _fold(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, heads, D] -> [B * heads * n_rep, S, D], each head repeated
    n_rep times (the reference's `jnp.repeat` of the KV heads)."""
    b, s, n, d = x.shape
    return x.transpose(1, 2).repeat_interleave(n_rep, dim=1).reshape(b * n * n_rep, s, d)


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
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    dsum = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [B, H, Sq]
    if _on_cuda(q):
        return _kernel.flash_attention_bwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.contiguous(), dsum, **kw,
        )
    n_rep = h // kvh
    dq, dk, dv = _ref.flash_attention_bwd_ref(
        _fold(q, 1), _fold(k, n_rep), _fold(v, n_rep), _fold(do, 1),
        lse.reshape(b * h, sq), dsum.reshape(b * h, sq), **kw,
    )

    def unfold_kv(x):  # the repeat's transpose: a group sum in x's dtype
        return x.reshape(b, kvh, n_rep, skv, dh).sum(dim=2).transpose(1, 2)

    return dq.reshape(b, h, sq, dh).transpose(1, 2), unfold_kv(dk), unfold_kv(dv)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out, **ctx.kw)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention over [B, S, H, D] with GQA, the reference's
    `ops.flash_attention`: out [B, Sq, H, D] in q's dtype."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, kw)
