"""The transformer LM family (the reference's `repro/models/lm.py`):
parameters, the KV cache, prefill and one decode step for serving;
`forward`, `loss_fn` and `make_train_step` for training.

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

Training: `forward` runs the same layer loop with autograd on;
``cfg.remat`` checkpoints each layer (`torch.utils.checkpoint`,
non-reentrant), recomputing its forward in the backward with no effect
on the numbers. `make_train_step` takes gradients with
`torch.autograd.grad` over the parameter leaves and, with several
microbatches, splits the batch the reference's strided way and adds the
microbatches' gradients in place, in the parameters' dtype.

Mixture-of-experts models (``cfg.num_experts`` > 0) run `models.moe.moe_ffn`
in place of the dense MLP, over the block's [B * S] tokens flattened, as
the reference does: prefill and the training forward at
``cfg.capacity_factor``, `decode_step` at ``max(capacity_factor, 2.0)``
over its B tokens. A short serving batch is padded by the engine, so the
padding rows take capacity as in the reference. ``cfg.dense_residual``
(Arctic) adds the dense gated MLP, run in parallel on the same input.
`forward` returns the layers' summed load-balancing loss.

AFMoE (Trinity, an `AFMoEConfig`) runs `_afmoe_block`: per-layer
attention types, q / k norms, RoPE on sliding layers only, the
attention's sigmoid gate, sandwich norms, the muP embedding scale, two
leading dense layers, then `models.moe.afmoe_moe` over the experts this
device holds. Its parameter tree splits the layers' MLPs into
`dense_layers` and `moe_layers`. ``make_train_step(cfg, optimizer,
"fopo", plan=, unembed=)`` trains it as a FOPO-LM policy
(`_fopo_train_step`).
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.configs_base import AFMoEConfig, LMConfig
from repro_torch.models.layers import gated_mlp, rms_norm, rope, softcap
from repro_torch.models.moe import afmoe_moe, moe_ffn
from repro_torch.obs import trace as _trace
from repro_torch.optim.optimizers import grad_like, tree_leaves, value_and_grad

__all__ = [
    "KVCache", "abstract_cache", "abstract_params", "compute_params", "decode_step",
    "final_hidden", "forward",
    "init_cache", "init_params",
    "loss_and_grads", "loss_fn", "make_train_step", "prefill",
]


class KVCache(NamedTuple):
    k: torch.Tensor  # [n_layers, B, S, KV, Dh]
    v: torch.Tensor  # [n_layers, B, S, KV, Dh]
    length: int  # filled prefix


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def init_params(cfg: LMConfig, generator: torch.Generator, device=None) -> Any:
    """Random parameters: N(0, 1 / fan_in) matrices drawn in fp32 from
    ``generator`` (on its device unless ``device`` says otherwise) and
    cast to ``cfg.dtype``; zero norm scales (the norm's gain is 1 +
    scale). A mixture of experts has `router` [n, d, E] and the experts'
    `we_gate` / `we_up` [n, E, d, f] and `we_down` [n, E, f, d] (f =
    ``moe_d_ff or d_ff``) in place of the dense MLP, which it keeps only
    with ``dense_residual``."""
    dev = device if device is not None else generator.device
    dtype = _dtype(cfg.dtype)
    d, dh, h, kv = cfg.d_model, cfg.dh, cfg.num_heads, cfg.num_kv_heads
    n = cfg.num_layers

    def mat(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    if isinstance(cfg, AFMoEConfig):
        return _init_afmoe(cfg, mat, lambda shape: torch.zeros(shape, dtype=dtype, device=dev))

    layers = {
        "attn_norm": torch.zeros((n, d), dtype=dtype, device=dev),
        "mlp_norm": torch.zeros((n, d), dtype=dtype, device=dev),
        "wq": mat((n, d, h * dh), d),
        "wk": mat((n, d, kv * dh), d),
        "wv": mat((n, d, kv * dh), d),
        "wo": mat((n, h * dh, d), h * dh),
    }
    if cfg.num_experts:
        e, eff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        layers.update(
            router=mat((n, d, e), d),
            we_gate=mat((n, e, d, eff), d),
            we_up=mat((n, e, d, eff), d),
            we_down=mat((n, e, eff, d), eff),
        )
    if not cfg.num_experts or cfg.dense_residual:
        layers.update(
            w_gate=mat((n, d, cfg.d_ff), d),
            w_up=mat((n, d, cfg.d_ff), d),
            w_down=mat((n, cfg.d_ff, d), cfg.d_ff),
        )
    params = {
        "embed": mat((cfg.vocab_size, d), d),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = mat((cfg.vocab_size, d), d)
    return params


def _init_afmoe(cfg: AFMoEConfig, mat, zeros) -> dict:
    """AFMoE's parameters: `layers` holds every layer's attention and its
    four norms (`attn_norm`, `post_attn_norm`, `mlp_norm`,
    `post_mlp_norm`), the q / k norms [n, Dh] and the gate `wg` [n, d,
    H Dh]; `dense_layers` the leading layers' MLP; `moe_layers` the
    router over every expert [n_moe, d, E], the held experts `we_*` [n_moe,
    H_held, ...] and the shared ones `ws_*` [n_moe, N, ...]."""
    d, dh, h, kv, n = cfg.d_model, cfg.dh, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    n_dense = cfg.num_dense_layers
    n_moe, f = n - n_dense, cfg.moe_d_ff or cfg.d_ff
    e_held, e_shared = cfg.num_held_experts, cfg.num_shared_experts
    params = {
        "embed": mat((cfg.vocab_size, d), d),
        "final_norm": zeros((d,)),
        "layers": {
            **{name: zeros((n, d)) for name in
               ("attn_norm", "post_attn_norm", "mlp_norm", "post_mlp_norm")},
            "q_norm": zeros((n, dh)),
            "k_norm": zeros((n, dh)),
            "wq": mat((n, d, h * dh), d),
            "wk": mat((n, d, kv * dh), d),
            "wv": mat((n, d, kv * dh), d),
            "wg": mat((n, d, h * dh), d),
            "wo": mat((n, h * dh, d), h * dh),
        },
        "dense_layers": {
            "w_gate": mat((n_dense, d, cfg.d_ff), d),
            "w_up": mat((n_dense, d, cfg.d_ff), d),
            "w_down": mat((n_dense, cfg.d_ff, d), cfg.d_ff),
        },
        "moe_layers": {
            "router": mat((n_moe, d, cfg.num_experts), d),
            "we_gate": mat((n_moe, e_held, d, f), d),
            "we_up": mat((n_moe, e_held, d, f), d),
            "we_down": mat((n_moe, e_held, f, d), f),
            "ws_gate": mat((n_moe, e_shared, d, f), d),
            "ws_up": mat((n_moe, e_shared, d, f), d),
            "ws_down": mat((n_moe, e_shared, f, d), f),
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = mat((cfg.vocab_size, d), d)
    return params


def abstract_params(cfg: LMConfig) -> Any:
    """The parameter tree's shapes and dtypes, on the meta device (the
    reference's `jax.eval_shape` of `init_params`)."""
    return init_params(cfg, torch.Generator(), device="meta")


def abstract_cache(cfg: LMConfig, batch: int, max_len: int) -> KVCache:
    """The cache's shapes and dtypes, on the meta device (the reference's
    `abstract_cache`; its `length` is a 0-dim int32, the port's an int)."""
    return init_cache(cfg, batch, max_len, device="meta")


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
    on even layers and global on odd ones; AFMoE's "sliding" layers have
    the window, its "full" ones none."""
    if isinstance(cfg, AFMoEConfig):
        return cfg.sliding_window if cfg.layer_types[i] == "sliding" else None
    if cfg.local_global_alternating and cfg.sliding_window:
        return cfg.sliding_window if i % 2 == 0 else None
    return cfg.sliding_window or None


def _self_attention(cfg: LMConfig, q, k_, v_, *, window):
    """Dispatch: the chunked plain-torch attention, or the flash-attention
    kernel (K9) when ``cfg.use_flash_kernel`` (laid out over
    ``cfg.flash_axes`` when q is a DTensor)."""
    if not cfg.use_flash_kernel:
        return flash_attention(
            q, k_, v_, causal=True, window=window, logit_cap=cfg.attn_logit_softcap
        )
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return fa_ops.flash_attention(
        q, k_, v_, causal=True, window=window, logit_cap=cfg.attn_logit_softcap,
        flash_axes=cfg.flash_axes,
    )


def _embed(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if isinstance(cfg, AFMoEConfig):
        return x * math.sqrt(float(cfg.d_model))
    if cfg.name.startswith("gemma"):
        # the scale is cast to x's dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=x.dtype, device=x.device)
    return x


def _head(cfg: LMConfig, params, x: torch.Tensor, return_hidden: bool) -> torch.Tensor:
    """x [..., d] after the final norm -> hidden, or soft-capped logits."""
    if return_hidden:
        return x
    unembed = params.get("unembed", params["embed"])
    return softcap(x @ unembed.T, cfg.final_logit_softcap)


def _layers(params) -> list[dict]:
    """Per-layer views of the stacked [n_layers, ...] leaves. `unbind`
    makes them in one op, whose backward stacks the layers' gradients once
    (a view per `w[i]` would add a zero-filled full-size gradient per
    layer). On a mesh each view's gradient takes the view's layout
    (`optimizers.grad_like`) before the stack."""
    def views(group: dict) -> list[dict]:
        per_name = {name: [grad_like(x) for x in w.unbind(0)] for name, w in group.items()}
        n = len(next(iter(per_name.values())))
        return [{name: ws[i] for name, ws in per_name.items()} for i in range(n)]

    layers = views(params["layers"])
    if "moe_layers" in params:  # AFMoE: the leading dense layers' MLP, then the MoE layers'
        ffn = views(params["dense_layers"]) + views(params["moe_layers"])
        layers = [{**a, **b} for a, b in zip(layers, ffn, strict=True)]
    return layers


def _ffn(cfg: LMConfig, y: torch.Tensor, layer: dict,
         capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN over y [B, S, d]: (out, the MoE aux loss or None).
    A mixture of experts routes the B * S tokens of this call together."""
    dense = lambda: gated_mlp(  # noqa: E731
        y, layer["w_gate"], layer["w_up"], layer["w_down"], cfg.gated_act)
    if not cfg.num_experts:
        return dense(), None
    b, s, d = y.shape
    out, aux = moe_ffn(
        y.reshape(b * s, d), layer["router"], layer["we_gate"], layer["we_up"],
        layer["we_down"], num_experts_per_tok=cfg.num_experts_per_tok,
        capacity_factor=capacity_factor, act=cfg.gated_act,
    )
    out = out.reshape(b, s, d)
    if cfg.dense_residual:
        out = out + dense()
    return out, aux["aux_loss"]


class _HostCountBackward(torch.autograd.Function):
    """The identity; its backward adds ``n`` to the ambient tracer's host
    counter ``name``."""

    @staticmethod
    def forward(ctx, x, name, n):
        ctx.name, ctx.n = name, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _trace.count(ctx.name, ctx.n)
        return g, None, None


@functools.lru_cache(maxsize=64)
def _live_pairs(s: int, window: int | None) -> int:
    from repro_torch.kernels.flash_attention.kernel import live_pairs

    return live_pairs(s, s, True, window, 0)


def _afmoe_block(cfg: AFMoEConfig, i: int, x: torch.Tensor, layer: dict,
                 positions: torch.Tensor, record: dict | None = None):
    """AFMoE's block i over x [B, S, d] (`modeling_afmoe.py`'s decoder
    layer): q and k RMS-normed a head, then RoPE on "sliding" layers only,
    attention over the layer's window, the output times sigmoid(y W_g),
    the output projection normed again before the residual (sandwich),
    then the MLP between its two norms. With a tracer active the
    attention adds B x its live (query, key) pairs to the host counter
    ``attention.pairs.<type>`` each forward pass and
    ``attention.pairs.<type>_backward`` each backward pass."""
    b, s, d = x.shape
    h, kv, dh, eps = cfg.num_heads, cfg.num_kv_heads, cfg.dh, cfg.rms_eps
    kind, window = cfg.layer_types[i], layer_window(cfg, i)
    y = rms_norm(x, layer["attn_norm"], eps)
    q = (y @ layer["wq"]).reshape(b, s, h, dh)
    k_ = (y @ layer["wk"]).reshape(b, s, kv, dh)
    v_ = (y @ layer["wv"]).reshape(b, s, kv, dh)
    q, k_ = rms_norm(q, layer["q_norm"], eps), rms_norm(k_, layer["k_norm"], eps)
    if _uses_rope(cfg, i):
        q, k_ = rope(q, positions, cfg.rope_theta), rope(k_, positions, cfg.rope_theta)
    with _trace.span("attention", window=window):
        att = _self_attention(cfg, q, k_, v_, window=window).reshape(b, s, h * dh)
    if _trace.current() is not None:
        pairs = b * _live_pairs(s, window)
        _trace.count(f"attention.pairs.{kind}", pairs)
        if att.requires_grad:
            att = _HostCountBackward.apply(att, f"attention.pairs.{kind}_backward", pairs)
    att = att * torch.sigmoid(y @ layer["wg"])
    x = x + rms_norm(att @ layer["wo"], layer["post_attn_norm"], eps)
    z = rms_norm(x, layer["mlp_norm"], eps)
    if i < cfg.num_dense_layers:
        f = gated_mlp(z, layer["w_gate"], layer["w_up"], layer["w_down"], cfg.gated_act)
    else:
        zf = z.reshape(b * s, d)
        if record is not None:
            record.setdefault("moe_inputs", []).append(zf.detach())
        f = afmoe_moe(zf, layer, k=cfg.num_experts_per_tok, route_norm=cfg.route_norm,
                      route_scale=cfg.route_scale, held=_held(cfg),
                      record=None if record is None else record.setdefault("routes", []))
        f = f.reshape(b, s, d)
    return x + rms_norm(f, layer["post_mlp_norm"], eps), k_, v_, None


def _uses_rope(cfg: AFMoEConfig, i: int) -> bool:
    """RoPE on "sliding" layers; "full" ones have no position encoding."""
    return cfg.layer_types[i] == "sliding"


def _held(cfg: AFMoEConfig) -> tuple[int, int]:
    return cfg.held_experts or (0, cfg.num_experts)


def _block(cfg: LMConfig, x: torch.Tensor, layer: dict, positions: torch.Tensor,
           window: int | None):
    """One transformer block over x [B, S, d]: (x out, this layer's k, v
    [B, S, KV, Dh], its MoE aux loss or None)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    y = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q = rope((y @ layer["wq"]).reshape(b, s, h, dh), positions, cfg.rope_theta)
    k_ = rope((y @ layer["wk"]).reshape(b, s, kv, dh), positions, cfg.rope_theta)
    v_ = (y @ layer["wv"]).reshape(b, s, kv, dh)
    att = _self_attention(cfg, q, k_, v_, window=window)
    x = x + att.reshape(b, s, h * dh) @ layer["wo"]
    ffn_out, aux = _ffn(cfg, rms_norm(x, layer["mlp_norm"], cfg.rms_eps), layer,
                        cfg.capacity_factor)
    return x + ffn_out, k_, v_, aux


@torch.inference_mode()
def prefill(cfg: LMConfig, params, tokens: torch.Tensor, cache: KVCache,
            *, return_hidden: bool = False):
    """Process a full prompt [B, S], write its keys and values into the
    cache (positions 0..S-1), and return the last position's soft-capped
    logits [B, V] — or, with ``return_hidden``, its hidden state [B, d]
    after the final norm (the serve route's MIPS query over the unembed
    rows; the soft-cap is monotonic, so the argmax is the same)."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i, layer in enumerate(_layers(params)):
        if isinstance(cfg, AFMoEConfig):
            x, k_, v_, _ = _afmoe_block(cfg, i, x, layer, positions)
        else:
            x, k_, v_, _ = _block(cfg, x, layer, positions, layer_window(cfg, i))
        cache.k[i, :, :s] = k_.to(cache.k.dtype)
        cache.v[i, :, :s] = v_.to(cache.v.dtype)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(cfg, params, x[:, -1], return_hidden), cache._replace(length=s)


@torch.inference_mode()
def decode_step(cfg: LMConfig, params, token: torch.Tensor, cache: KVCache,
                *, return_hidden: bool = False):
    """One decode step: token [B] at position ``cache.length`` -> (logits
    [B, V], or the hidden state [B, d] with ``return_hidden``; the cache
    with that position written). A mixture of experts routes the B tokens
    at capacity factor ``max(cfg.capacity_factor, 2.0)``, as the reference."""
    b = token.shape[0]
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    pos_i = cache.length
    x = _embed(cfg, params, token[:, None])  # [B, 1, d]
    pos = torch.full((b, 1), pos_i, device=x.device)
    for i, layer in enumerate(_layers(params)):
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
        x = x + _ffn(cfg, y, layer, max(cfg.capacity_factor, 2.0))[0]
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(cfg, params, x[:, 0], return_hidden), cache._replace(length=pos_i + 1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def forward(cfg: LMConfig, params, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (soft-capped logits [B, S, V], the MoE aux loss: the
    layers' load-balancing losses summed, a 0-dim fp32 zero for a dense
    model)."""
    x, aux_loss = _trunk(cfg, params, tokens)
    return _head(cfg, params, x, False), aux_loss


def final_hidden(cfg: LMConfig, params, tokens: torch.Tensor,
                 record: dict | None = None) -> torch.Tensor:
    """tokens [B, S] -> the hidden states [B, S, d] after the final norm,
    before the unembedding: what the FOPO LM head (`core.lm_head`) reads.
    An AFMoE model appends each MoE layer's input [B S, d] and selection
    [B S, k] to ``record["moe_inputs"]`` / ``record["routes"]`` where
    ``record`` is given."""
    return _trunk(cfg, params, tokens, record)[0]


def _trunk(cfg: LMConfig, params, tokens: torch.Tensor,
           record: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers and the final norm: (hidden [B, S, d], summed aux loss)."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    afmoe = isinstance(cfg, AFMoEConfig)
    for i, layer in enumerate(_layers(params)):
        def fn(x_, layer=layer, window=layer_window(cfg, i), i=i):
            if afmoe:
                x_, _, _, aux = _afmoe_block(cfg, i, x_, layer, positions, record)
            else:
                x_, _, _, aux = _block(cfg, x_, layer, positions, window)
            return x_, aux

        if cfg.remat and torch.is_grad_enabled():
            # the layer draws no random numbers: no RNG state to keep
            x, aux = checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = fn(x)
        if aux is not None:
            aux_loss = aux_loss + aux
    return rms_norm(x, params["final_norm"], cfg.rms_eps), aux_loss


def loss_fn(cfg: LMConfig, params, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over B x S, on the logits in fp32,
    plus 0.01 times the aux loss."""
    logits, aux = forward(cfg, params, tokens)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)  # [B, S]
    return torch.mean(logz - _gold(lf, labels)) + 0.01 * aux


def _gold(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """lf [B, S, V] at each label: [B, S]. Logits that are a DTensor
    sharded over the vocab take it as a masked sum (the same number: the
    label's entry plus zeros), whose backward stays sharded where a
    gather's would scatter into a replicated [B, S, V] of zeros."""
    from torch.distributed.tensor import DTensor

    idx = labels.long()[..., None]
    if isinstance(lf, DTensor):
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        return torch.where(vocab == idx, lf, 0.0).sum(dim=-1)
    return torch.gather(lf, -1, idx)[..., 0]


def loss_and_grads(cfg: LMConfig, params, tokens: torch.Tensor,
                   labels: torch.Tensor) -> tuple[torch.Tensor, Any]:
    """(loss, gradients shaped and typed like ``params``), by
    `optim.optimizers.value_and_grad` (the caller's tensors are not
    touched)."""
    return value_and_grad(lambda tree: loss_fn(cfg, tree, tokens, labels), params)


def make_train_step(cfg: LMConfig, optimizer, objective: str = "xent", *, plan=None,
                    unembed: torch.Tensor | None = None):
    """(params, opt_state, tokens, labels) -> (params, opt_state, loss).
    With ``cfg.microbatch`` giving n_micro > 1 microbatches, micro j takes
    rows {j, n_micro + j, ...} (the reference's strided split); their
    gradients are added in place in the parameters' dtype and divided by
    n_micro, their losses summed in fp32 and divided likewise.

    ``objective="fopo"`` trains the LM as a FOPO-LM policy instead
    (`_fopo_train_step`): ``plan`` (an `ExecutionPlan`) runs the step over
    the frozen ``unembed`` [V, d], the catalog."""
    if objective == "fopo":
        if plan is None or unembed is None:
            raise ValueError('objective="fopo" needs plan= and unembed=')
        return _fopo_train_step(cfg, optimizer, plan, unembed)
    if objective != "xent":
        raise ValueError(f"unknown objective {objective!r}")

    def train_step(params, opt_state, tokens, labels):
        b = tokens.shape[0]
        mb = cfg.microbatch or b
        n_micro = max(1, b // mb)
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, params, tokens, labels)
        else:
            if b != mb * n_micro:
                raise ValueError(f"batch {b} is not a multiple of microbatch {mb}")
            # rows {j, n_micro + j, ...} as a view of [mb, n_micro, S]: the
            # same rows as a strided slice, and a batch-sharded DTensor keeps
            # its sharding through it
            tok = tokens.reshape(mb, n_micro, -1)
            lab = labels.reshape(mb, n_micro, -1)
            loss, grads = loss_and_grads(cfg, params, tok[:, 0], lab[:, 0])
            for j in range(1, n_micro):
                l_j, g_j = loss_and_grads(cfg, params, tok[:, j], lab[:, j])
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_j)):
                    acc.add_(g)
                loss = loss + l_j
                del g_j
            for acc in tree_leaves(grads):
                acc.div_(n_micro)
            loss = loss / n_micro
        # hand the update the only reference to the gradients, so that it
        # frees each leaf once that leaf's moments are formed
        box = [grads]
        del grads
        params, opt_state = optimizer.update(box.pop(), opt_state, params)
        return params, opt_state, loss

    return train_step


def compute_params(cfg: LMConfig, params) -> Any:
    """The parameters the trunk runs on: with ``cfg.compute_dtype`` a copy
    of every floating leaf in that dtype (the cast is differentiable, so
    the gradients reach the fp32 masters in fp32), the routers kept in
    fp32; without it ``params`` itself."""
    dt = getattr(cfg, "compute_dtype", None)
    if dt is None:
        return params

    def cast(tree, keep=False):
        if isinstance(tree, dict):
            return {k: cast(v, keep or k == "router") for k, v in tree.items()}
        return tree if keep or not tree.is_floating_point() else tree.to(_dtype(dt))

    return cast(params)


def _fopo_train_step(cfg: LMConfig, optimizer, plan, unembed: torch.Tensor):
    """(params, opt_state, batch, seed) -> (params, opt_state, loss, aux):
    one FOPO-LM step (`core.lm_head`'s estimator through the plan). Each
    token position is a context; the policy's tower is `final_hidden`
    flattened to [B S, d] in fp32; beta is ``unembed`` (frozen, outside
    ``params``); the reward is `make_session_reward` with each position's
    next token, ``batch["labels"]`` [B, S] (-1 where there is none), as
    its positive. ``batch["tokens"]`` [B, S] are the inputs. The trunk
    runs on `compute_params` (cast once a step); ``plan.execute`` does the
    rest, its detached proposal forward included. ``aux`` is the plan's
    diagnostics. The keyword ``record`` (a dict) gets the proposal pass's
    MoE inputs and selections (`final_hidden`) and its ``hidden`` [B S,
    d]."""
    from repro_torch.core.policy import SoftmaxPolicy
    from repro_torch.core.rewards import make_session_reward

    beta = unembed.detach()

    def train_step(params, opt_state, batch, seed: int, *, record: dict | None = None):
        tokens, labels = batch["tokens"], batch["labels"]
        reward_fn = make_session_reward(labels.reshape(-1, 1))
        passes = [0]

        def tower(p, toks):
            rec = record if passes[0] == 0 else None
            passes[0] += 1
            h = final_hidden(cfg, p, toks, rec)
            h = h.reshape(-1, h.shape[-1]).float()
            if rec is not None:
                rec["hidden"] = h.detach()
            return h

        policy = SoftmaxPolicy(tower=tower, item_dim=cfg.d_model)
        aux_box: dict = {}

        def loss(p):
            value, aux = plan.execute(policy, compute_params(cfg, p), seed, tokens, beta,
                                      reward_fn)
            aux_box.update(aux)
            return value

        loss_val, grads = value_and_grad(loss, params)
        box = [grads]
        del grads
        params, opt_state = optimizer.update(box.pop(), opt_state, params)
        return params, opt_state, loss_val, {k: v.detach() for k, v in aux_box.items()}

    return train_step
