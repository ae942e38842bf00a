"""Public wrapper of the flash-attention forward kernel, over the
model's [B, S, H, D] layout with grouped KV heads ([B, S, KV, D]).

`flash_attention` is a `torch.autograd.Function` whose forward is the
kernel (the reference's `ops.flash_attention` is a `jax.custom_vjp`); its
backward, the reference's `flash_backward_pallas` (K10), comes with the
LM training slice and raises until then. `flash_attention_fwd` returns
the per-row logsumexp beside the output.

Dispatch is by the device of the tensors. On the CPU it is the plain
PyTorch version (`ref.py`) over [B*H, S, D], with the KV heads repeated;
on CUDA it is the hand-written kernel, or an error, with no fallback
from the kernel to the plain version. The kernel masks ragged sequence
ends and reads each KV head in place, so on the card nothing is
repeated, padded, transposed or copied. The reference's
``tile_q``/``tile_kv`` have no counterpart: its Pallas grid needs the
sequence padded to whole tiles, while neither the kernel nor the plain
version does, and the result does not depend on the tiling.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "flash_attention_fwd"]


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
    qf = q.transpose(1, 2).reshape(b * h, sq, dh)
    kf = k.transpose(1, 2).repeat_interleave(n_rep, dim=1).reshape(b * h, skv, dh)
    vf = v.transpose(1, 2).repeat_interleave(n_rep, dim=1).reshape(b * h, skv, dh)
    out, lse = _ref.flash_attention_ref(qf, kf, vf, **kw)
    return out.reshape(b, h, sq, dh).transpose(1, 2), lse.reshape(b, h, sq)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kw):  # noqa: ARG004 — no residuals until K10
        out, _ = flash_attention_fwd(q, k, v, **kw)
        return out

    @staticmethod
    def backward(ctx, grad_out):  # noqa: ARG004
        raise NotImplementedError(
            "the flash-attention backward (the reference's flash_backward_pallas, "
            "K10) is not ported yet; it comes with the LM training slice"
        )


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
