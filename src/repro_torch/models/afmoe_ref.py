"""A plain reference of AFMoE (Trinity) as a FOPO-LM policy, for the CPU
tests: plain `torch` ops in fp32 with TF32 off, one op after another, no
cache, no kernel, nothing of `repro_torch.kernels` (and nothing of the
JAX package). `bench/reference/afmoe.py` is the benchmark's copy.

The model is `modeling_afmoe.py`'s (the model's published modeling code)
over the port's parameter layout (`models.lm.init_params` of an
`AFMoEConfig`): per layer, RMSNorm(x) -> q, k, v; q and k RMS-normed a
head; RoPE on "sliding" layers only (none on "full" ones); softmax
attention with the causal mask and, on sliding layers, the window
(query i sees keys j with i - window < j <= i); the output times
sigmoid(y W_g), then W_o, then a norm (sandwich) and the residual; the
MLP between its two norms: SwiGLU on the leading dense layers, then the
MoE: s = sigmoid(y W_r) in fp32 over every expert, the top-k of s,
weights s / (sum + 1e-20) * route_scale, the held experts' weighted
SwiGLU outputs plus the shared expert's. The embedding is scaled by
sqrt(d). Norms scale by 1 + scale (the port's parameterisation: a
zero-initialised scale is the unit gain).

Departures from the published model, the program's too: the expert
bias is held at zero (its out-of-gradient update, `load_balance_coeff`,
is left out), so the selection is the top-k of s; the weights are random
(no depth-scaled initialisation); a device that holds some of the
experts computes their part only (``held``).
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["attention", "forward", "fopo_lm_loss", "loss_and_grads", "moe_layer", "no_tf32",
           "rms_norm", "rope", "route"]


@contextlib.contextmanager
def no_tf32():
    """IEEE fp32 products for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, theta: float):
    """x [B, S, H, Dh], position = index along S; rotate the two halves."""
    s, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window):
    """Softmax attention [B, S, H, Dh] with KV heads shared by groups."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask = mask & (i[:, None] - i[None, :] < window)
    p = torch.softmax(torch.where(mask, scores, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def swiglu(x, w_gate, w_up, w_down):
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def route(y, router, k: int, route_norm: bool, route_scale: float, selected=None):
    """(selected [T, k], weights [T, k], scores [T, E]); ``selected`` given
    is followed in place of the top-k."""
    s = torch.sigmoid(y @ router)
    sel = torch.topk(s, k, dim=-1).indices if selected is None else selected.long()
    w = torch.gather(s, 1, sel)
    if route_norm:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return sel, w * route_scale, s


def moe_layer(cfg, y, layer: dict, held: tuple[int, int], selected=None):
    """The MoE over y [T, d]: (out [T, d], selected). Each held expert's
    tokens one after another, then the shared experts."""
    sel, w, _ = route(y, layer["router"], cfg.num_experts_per_tok, cfg.route_norm,
                      cfg.route_scale, selected)
    out = torch.zeros_like(y)
    for j in range(layer["we_gate"].shape[0]):
        tok, slot = torch.nonzero(sel == held[0] + j, as_tuple=True)
        if tok.numel():
            part = swiglu(y[tok], layer["we_gate"][j], layer["we_up"][j], layer["we_down"][j])
            out = out.index_add(0, tok, part * w[tok, slot][:, None])
    for j in range(layer["ws_gate"].shape[0]):
        out = out + swiglu(y, layer["ws_gate"][j], layer["ws_up"][j], layer["ws_down"][j])
    return out, sel


def _layer(params: dict, i: int) -> dict:
    out = {k: v[i] for k, v in params["layers"].items()}
    n_dense = params["dense_layers"]["w_gate"].shape[0]
    group, j = ("dense_layers", i) if i < n_dense else ("moe_layers", i - n_dense)
    out.update({k: v[j] for k, v in params[group].items()})
    return out


def forward(cfg, params: dict, tokens, *, held=None, routes=None):
    """tokens [B, S] -> (hidden [B, S, d] after the final norm, each MoE
    layer's input [B S, d] and selection [B S, k]). ``routes`` (one
    selection an MoE layer) is followed where given."""
    held = held or cfg.held_experts or (0, cfg.num_experts)
    eps = cfg.rms_eps
    b, s = tokens.shape
    x = params["embed"][tokens.long()] * math.sqrt(cfg.d_model)
    inputs, sels = [], []
    with no_tf32():
        for i in range(cfg.num_layers):
            lay = _layer(params, i)
            y = rms_norm(x, lay["attn_norm"], eps)
            q = (y @ lay["wq"]).reshape(b, s, cfg.num_heads, cfg.dh)
            k = (y @ lay["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.dh)
            v = (y @ lay["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.dh)
            q, k = rms_norm(q, lay["q_norm"], eps), rms_norm(k, lay["k_norm"], eps)
            full = cfg.layer_types[i] == "full"
            if not full:
                q, k = rope(q, cfg.rope_theta), rope(k, cfg.rope_theta)
            att = attention(q, k, v, None if full else cfg.sliding_window).reshape(b, s, -1)
            att = att * torch.sigmoid(y @ lay["wg"])
            x = x + rms_norm(att @ lay["wo"], lay["post_attn_norm"], eps)
            z = rms_norm(x, lay["mlp_norm"], eps)
            if i < cfg.num_dense_layers:
                f = swiglu(z, lay["w_gate"], lay["w_up"], lay["w_down"])
            else:
                zf = z.reshape(b * s, -1)
                given = None if routes is None else routes[len(sels)]
                f, sel = moe_layer(cfg, zf, lay, held, given)
                inputs.append(zf)
                sels.append(sel)
                f = f.reshape(b, s, -1)
            x = x + rms_norm(f, lay["post_mlp_norm"], eps)
        return rms_norm(x, params["final_norm"], eps), inputs, sels


def fopo_lm_loss(hidden, beta, actions, log_q, rewards):
    """The FOPO-LM surrogate over hidden [N, d] and the frozen beta [V, d]:
    (loss, ess). Its gradient in ``hidden`` is the SNIS covariance
    gradient: c = wbar (r - rbar), held fixed, loss = -mean_n sum_s c f."""
    valid = actions >= 0
    with no_tf32():
        scores = torch.einsum("nd,nsd->ns", hidden, beta[actions.clamp(min=0).long()])
    wbar = torch.softmax(scores.detach() - log_q, dim=-1) * valid
    rbar = (wbar * rewards).sum(dim=-1, keepdim=True)
    coeff = (wbar * (rewards - rbar)).detach()
    loss = -torch.mean(torch.sum(coeff * scores, dim=-1))
    denom = torch.sum(wbar**2, dim=-1)
    ess = torch.mean(torch.where(denom > 0, 1.0 / denom.clamp(min=1e-30), 0.0))
    return loss, ess


def loss_and_grads(cfg, params: dict, tokens, beta, actions, log_q, rewards, *, routes=None):
    """(loss, ess, hidden [N, d], gradients shaped like ``params``) by
    autograd, over fp32 copies of the parameters."""
    leaves = {}

    def req(tree, path=()):
        if isinstance(tree, dict):
            return {k: req(v, path + (k,)) for k, v in tree.items()}
        leaves[path] = t = tree.detach().float().requires_grad_(True)
        return t

    p = req(params)
    h = forward(cfg, p, tokens, routes=routes)[0]
    h = h.reshape(-1, h.shape[-1])
    loss, ess = fopo_lm_loss(h, beta.float(), actions, log_q, rewards)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out: dict = {}
    for (path, leaf), g in zip(leaves.items(), grads):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.zeros_like(leaf) if g is None else g
    return loss.detach(), ess.detach(), h.detach(), out
