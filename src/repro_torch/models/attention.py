"""Attention in plain PyTorch: the chunked online-softmax prefill and the
single-token decode against a KV cache.

`flash_attention` is the reference's flash formulation written out: an
outer loop over query chunks, an inner loop over KV chunks with an online
softmax, so the [S, S] score matrix is never held whole. Sliding windows
and the Gemma-2 logit soft-cap are masks and a tanh inside the loop. It
is the `use_flash_kernel=False` path of `models.lm`; the kernel path is
`repro_torch.kernels.flash_attention`.

This module keeps its own ``NEG_INF = -2e38``, as the reference's does,
not the value in `repro_torch.constants`.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import softcap

__all__ = ["NEG_INF", "decode_attention", "flash_attention"]

NEG_INF = -2.0e38


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, Dh] -> [B, S, KV*n_rep, Dh] (GQA head sharing)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _pad_seq(x: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - x.shape[1]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Skv, KV, Dh]
    v: torch.Tensor,  # [B, Skv, KV, Dh]
    *,
    causal: bool = True,
    q_offset: int = 0,  # absolute position of q[0]
    window: int | None = None,  # sliding-window size (None = global)
    logit_cap: float | None = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """out [B, Sq, H, Dh] in q's dtype; arithmetic in fp32."""
    b, sq, h, dh = q.shape
    skv, kv_heads = k.shape[1], k.shape[2]
    n_rep = h // kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32))

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nkv = -(-skv // kv_chunk)
    qc = _pad_seq(q, nq * q_chunk).transpose(1, 2)  # [B, H, Sq', Dh]
    kc = _pad_seq(k, nkv * kv_chunk).transpose(1, 2)
    vc = _pad_seq(v, nkv * kv_chunk).transpose(1, 2)
    dev = q.device
    scale = scale.to(dev)
    outs = []
    for qi in range(nq):
        # fp32 before the scale, as the reference's f32 scale promotes it
        qq = qc[:, :, qi * q_chunk:(qi + 1) * q_chunk].float() * scale  # [B, H, qc, Dh]
        qp = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, h, q_chunk, dh), dtype=torch.float32, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s = torch.einsum("bhqd,bhkd->bhqk", qq, kc[:, :, sl].float())
            s = softcap(s, logit_cap)
            kp = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (kp < skv)[None, :]
            if causal:
                mask = mask & (kp[None, :] <= qp[:, None])
            if window is not None:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vc[:, :, sl].float()
            )
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=2).transpose(1, 2)  # [B, Sq', H, Dh]
    return out[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, Dh]
    k_cache: torch.Tensor,  # [B, S, KV, Dh]
    v_cache: torch.Tensor,  # [B, S, KV, Dh]
    cache_len: int,  # valid prefix length
    *,
    window: int | None = None,
    logit_cap: float | None = None,
    gqa_einsum: bool = False,
    slice_window: bool = False,
) -> torch.Tensor:
    """Single-token attention against the cache: out [B, 1, H, Dh].

    ``gqa_einsum`` contracts grouped query heads against the cache in its
    [B, S, KV, Dh] layout instead of repeating KV heads; with it,
    ``slice_window`` reads only the last ``window`` cache entries. Both
    give the same numbers as the plain form."""
    b, _, h, dh = q.shape
    s, kv_heads = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kv_heads
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32)).to(q.device)

    if slice_window and gqa_einsum and window is not None and window < s:
        start = min(max(cache_len - window, 0), s - window)
        k_cache = k_cache[:, start:start + window]
        v_cache = v_cache[:, start:start + window]
        s = window
        pos = start + torch.arange(s, device=q.device)
    else:
        pos = torch.arange(s, device=q.device)
    mask = pos < cache_len  # [S]
    if window is not None:
        mask = mask & (pos >= cache_len - window)

    if gqa_einsum:
        qg = (q.float() * scale).reshape(b, kv_heads, n_rep, dh)  # [B, KV, rep, Dh]
        logits = torch.einsum("bkrd,bskd->bkrs", qg, k_cache.float())
        logits = softcap(logits, logit_cap)
        logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
        return out.reshape(b, 1, h, dh).to(q.dtype)

    kk = _repeat_kv(k_cache, n_rep)
    vv = _repeat_kv(v_cache, n_rep)
    logits = torch.einsum("bohd,bshd->bhs", q.float() * scale, kk.float())
    logits = softcap(logits, logit_cap)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vv.float())
    return out[:, None].to(q.dtype)  # [B, 1, H, Dh]
