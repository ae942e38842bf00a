"""The transformer LM family, serving half: parameters, the KV cache,
prefill and one decode step (the reference's `repro/models/lm.py`).

Parameters keep the reference's layout: a dict with `embed` [V, d],
`final_norm` [d], optional `unembed` [V, d], and `layers`, whose leaves
are stacked [n_layers, ...]. The layers run in a Python loop over views
of the stacked tensors, so each layer's attention window is static: an
alternating (local / global) model computes only the attention the
layer uses, where the reference computes both and selects one (the same
numbers for half the work).

Attention dispatches as the reference's `_self_attention` does:
``cfg.use_flash_kernel`` False runs the chunked plain-torch
`models.attention.flash_attention`, True the flash-attention kernel
(`repro_torch.kernels.flash_attention.ops.flash_attention`, K9), which
reads grouped KV heads in place.

The cache is written in place: `prefill` and `decode_step` store the new
keys and values into the tensors of the cache they are given and return
it with its length advanced (the reference returns an updated copy).
`length` is a Python int: positions are known on the host.

Not ported yet: the MoE layers (`moe_ffn`), `forward`, `loss_fn` and
`make_train_step` (the LM training slice).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.configs_base import LMConfig
from repro_torch.models.layers import gated_mlp, rms_norm, rope, softcap

__all__ = ["KVCache", "decode_step", "init_cache", "init_params", "prefill"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [n_layers, B, S, KV, Dh]
    v: torch.Tensor  # [n_layers, B, S, KV, Dh]
    length: int  # filled prefix


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def _check_dense(cfg: LMConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name} is a mixture of experts; moe_ffn is not ported to "
            "repro_torch yet (it comes with the models slice)"
        )


def init_params(cfg: LMConfig, generator: torch.Generator, device=None) -> Any:
    """Random parameters: N(0, 1 / fan_in) matrices drawn in fp32 from
    ``generator`` (on its device unless ``device`` says otherwise) and
    cast to ``cfg.dtype``; zero norm scales (the norm's gain is 1 +
    scale)."""
    _check_dense(cfg)
    dev = device if device is not None else generator.device
    dtype = _dtype(cfg.dtype)
    d, dh, h, kv = cfg.d_model, cfg.dh, cfg.num_heads, cfg.num_kv_heads
    n = cfg.num_layers

    def mat(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    layers = {
        "attn_norm": torch.zeros((n, d), dtype=dtype, device=dev),
        "mlp_norm": torch.zeros((n, d), dtype=dtype, device=dev),
        "wq": mat((n, d, h * dh), d),
        "wk": mat((n, d, kv * dh), d),
        "wv": mat((n, d, kv * dh), d),
        "wo": mat((n, h * dh, d), h * dh),
        "w_gate": mat((n, d, cfg.d_ff), d),
        "w_up": mat((n, d, cfg.d_ff), d),
        "w_down": mat((n, cfg.d_ff, d), cfg.d_ff),
    }
    params = {
        "embed": mat((cfg.vocab_size, d), d),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = mat((cfg.vocab_size, d), d)
    return params


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None) -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.dh)
    dt = _dtype(dtype or cfg.dtype)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        length=0,
    )


def layer_window(cfg: LMConfig, i: int) -> int | None:
    """Layer i's attention window: alternating models (Gemma-2) are local
    on even layers and global on odd ones."""
    if cfg.local_global_alternating and cfg.sliding_window:
        return cfg.sliding_window if i % 2 == 0 else None
    return cfg.sliding_window or None


def _self_attention(cfg: LMConfig, q, k_, v_, *, window):
    """Dispatch: the chunked plain-torch attention, or the flash-attention
    kernel (K9) when ``cfg.use_flash_kernel``."""
    if not cfg.use_flash_kernel:
        return flash_attention(
            q, k_, v_, causal=True, window=window, logit_cap=cfg.attn_logit_softcap
        )
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return fa_ops.flash_attention(
        q, k_, v_, causal=True, window=window, logit_cap=cfg.attn_logit_softcap
    )


def _embed(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.name.startswith("gemma"):
        # the scale is cast to x's dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=x.dtype, device=x.device)
    return x


def _head(cfg: LMConfig, params, x: torch.Tensor, return_hidden: bool) -> torch.Tensor:
    """x [B, d] after the final norm -> hidden, or soft-capped logits."""
    if return_hidden:
        return x
    unembed = params.get("unembed", params["embed"])
    return softcap(x @ unembed.T, cfg.final_logit_softcap)


def _layer(params, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


@torch.inference_mode()
def prefill(cfg: LMConfig, params, tokens: torch.Tensor, cache: KVCache,
            *, return_hidden: bool = False):
    """Process a full prompt [B, S], write its keys and values into the
    cache (positions 0..S-1), and return the last position's soft-capped
    logits [B, V] — or, with ``return_hidden``, its hidden state [B, d]
    after the final norm (the serve route's MIPS query over the unembed
    rows; the soft-cap is monotonic, so the argmax is the same)."""
    _check_dense(cfg)
    b, s = tokens.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.num_layers):
        layer = _layer(params, i)
        y = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q = rope((y @ layer["wq"]).reshape(b, s, h, dh), positions, cfg.rope_theta)
        k_ = rope((y @ layer["wk"]).reshape(b, s, kv, dh), positions, cfg.rope_theta)
        v_ = (y @ layer["wv"]).reshape(b, s, kv, dh)
        att = _self_attention(cfg, q, k_, v_, window=layer_window(cfg, i))
        x = x + att.reshape(b, s, h * dh) @ layer["wo"]
        y = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
        x = x + gated_mlp(y, layer["w_gate"], layer["w_up"], layer["w_down"], cfg.gated_act)
        cache.k[i, :, :s] = k_.to(cache.k.dtype)
        cache.v[i, :, :s] = v_.to(cache.v.dtype)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(cfg, params, x[:, -1], return_hidden), cache._replace(length=s)


@torch.inference_mode()
def decode_step(cfg: LMConfig, params, token: torch.Tensor, cache: KVCache,
                *, return_hidden: bool = False):
    """One decode step: token [B] at position ``cache.length`` -> (logits
    [B, V], or the hidden state [B, d] with ``return_hidden``; the cache
    with that position written)."""
    _check_dense(cfg)
    b = token.shape[0]
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    pos_i = cache.length
    x = _embed(cfg, params, token[:, None])  # [B, 1, d]
    pos = torch.full((b, 1), pos_i, device=x.device)
    for i in range(cfg.num_layers):
        layer = _layer(params, i)
        y = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q = rope((y @ layer["wq"]).reshape(b, 1, h, dh), pos, cfg.rope_theta)
        k_new = rope((y @ layer["wk"]).reshape(b, 1, kv, dh), pos, cfg.rope_theta)
        v_new = (y @ layer["wv"]).reshape(b, 1, kv, dh)
        cache.k[i, :, pos_i] = k_new[:, 0].to(cache.k.dtype)
        cache.v[i, :, pos_i] = v_new[:, 0].to(cache.v.dtype)
        att = decode_attention(
            q, cache.k[i], cache.v[i], pos_i + 1, window=layer_window(cfg, i),
            logit_cap=cfg.attn_logit_softcap, gqa_einsum=cfg.decode_gqa_einsum,
        )
        x = x + att.reshape(b, 1, h * dh) @ layer["wo"]
        y = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
        x = x + gated_mlp(y, layer["w_gate"], layer["w_up"], layer["w_down"], cfg.gated_act)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(cfg, params, x[:, 0], return_hidden), cache._replace(length=pos_i + 1)
