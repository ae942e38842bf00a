"""The plain reference of a Trinity-Mini (AFMoE) FOPO-LM step, the
benchmark's copy of `src/repro_torch/models/afmoe_ref.py`: plain `torch`
ops in fp32 with TF32 off (`precision.fp32_products`), no cache, nothing
of the program, computed in blocks so that it fits beside nothing else.

The model (`modeling_afmoe.py`, the model's published code), per layer:
RMSNorm(x) -> q, k, v; q and k RMS-normed a head; RoPE on "sliding"
layers only; causal softmax attention, on sliding layers over the window
(query i sees keys i - window < j <= i); the output times sigmoid(y
W_g); W_o; a norm (sandwich); the residual; then the MLP between its two
norms: SwiGLU on the leading dense layers, then the MoE: s = sigmoid(y
W_r) over every expert, the top-k of s, weights s / (sum + 1e-20) times
``route_scale``, the held experts' weighted SwiGLU outputs plus the
shared expert's. The embedding is scaled by sqrt(d). Norms scale by 1 +
scale (zero-initialised: the unit gain).

Departures, the program's too: the expert bias is held at zero (its
out-of-gradient update is left out), so the selection is the top-k of
s; the weights are random; the device holds experts [lo, hi) of each
MoE layer and computes their part only, the other devices' experts
adding nothing here.

The FOPO-LM step: each position is a context, h its final hidden state,
the frozen unembedding the catalog (beta). The top-K a step draws from
comes from the route's retrieval of h (``retrieve``) or is handed in
(``topk``, the program's, followed); the draws are the counter-hash
eps-mixture of `bench.reference.fopo.mixture_draws`; the reward is 1
for a position's next token; the SNIS covariance surrogate's gradient
reaches h, then every layer by autograd, one layer at a time (its
forward computed again from its stored input), attention in blocks of
queries, each recomputed in the backward.

``precision="fp8"`` is the control's trunk, below the stated bf16: every
product operand rounded to float8 e4m3 with a per-tensor scale (its
largest magnitude at 448), the gradient passed straight through; its
head (stated fp32) computes in TF32 (``head_precision``). Faults for the
calibration (`Fault`): RoPE on the full layers, the window on the full
layers, the held experts shifted to another device's.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import fopo as fopo_ref
from bench.reference import precision as fp32_precision

__all__ = ["LEAVES", "NO_FAULT", "Fault", "Model", "adam_leaves", "cast", "forward", "leaf",
           "route_gap", "step"]

PRECISIONS = ("fp32", "tf32", "fp8")
Q_BLOCK = 1024  # queries of one attention block
HEAD_BLOCK = 512  # rows of one block of the head's sampled scores


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes the reference reads from the cell's configuration."""

    d: int
    heads: int
    kv_heads: int
    dh: int
    layers: int
    dense_layers: int
    layer_types: tuple
    window: int
    k: int
    route_norm: bool
    route_scale: float
    eps: float
    theta: float
    held: tuple

    @classmethod
    def of(cls, c: dict) -> "Model":
        n = c["num_hidden_layers"]
        return cls(d=c["hidden_size"], heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"], dh=c["head_dim"], layers=n,
                   dense_layers=c["num_dense_layers"],
                   layer_types=tuple(c["layer_types"][:n]), window=c["sliding_window"],
                   k=c["num_experts_per_tok"], route_norm=c["route_norm"],
                   route_scale=c["route_scale"], eps=c["rms_norm_eps"], theta=c["rope_theta"],
                   held=tuple(c["held_experts"]))


@dataclasses.dataclass(frozen=True)
class Fault:
    rope_on_full: bool = False
    window_on_full: bool = False
    held_shift: int = 0  # the held experts' ids moved by this many


NO_FAULT = Fault()

# the gradient leaves the judge compares: (group, name, index...) into the
# parameter tree; layer 3 is the first full layer and the second MoE layer
LEAVES = {
    "router": ("moe_layers", "router", 1),
    "expert_gate": ("moe_layers", "we_gate", 1, 0),
    "expert_up": ("moe_layers", "we_up", 1, 0),
    "expert_down": ("moe_layers", "we_down", 1, 0),
    "shared_gate": ("moe_layers", "ws_gate", 1, 0),
    "shared_up": ("moe_layers", "ws_up", 1, 0),
    "shared_down": ("moe_layers", "ws_down", 1, 0),
    "gate_wg": ("layers", "wg", 0),
    "full_wq": ("layers", "wq", 3),
}


def leaf(params: dict, path: tuple) -> torch.Tensor:
    t = params[path[0]][path[1]]
    for i in path[2:]:
        t = t[i]
    return t


def _leaf_layer(m: Model, path: tuple) -> int:
    return path[2] + (m.dense_layers if path[0] == "moe_layers" else 0)


def cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product operand in ``precision``."""
    if precision == "fp32":
        return x
    if precision == "tf32":
        q = fp32_precision.cast(x.detach(), precision)
    elif precision == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    else:
        raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")
    return x + (q - x).detach()  # the value rounded, the gradient passed straight through


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x, theta: float):
    s, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q0: int, k0: int, window, precision: str):
    """One block: q [Q, H, Dh] at positions q0.., k / v [K, KV, Dh] at k0.."""
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", cast(q, precision), cast(k, precision))
    s = s / math.sqrt(q.shape[-1])
    qi = q0 + torch.arange(q.shape[0], device=q.device)[:, None]
    ki = k0 + torch.arange(k.shape[0], device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask = mask & (qi - ki < window)
    p = torch.softmax(torch.where(mask, s, -math.inf), dim=-1)
    return torch.einsum("hqk,khd->qhd", cast(p, precision), cast(v, precision))


def _attention(q, k, v, window, precision: str):
    """[B, S, H, Dh] in query blocks; a sliding block reads only the keys
    its window reaches. Under autograd each block is recomputed in the
    backward, so no block's scores are kept."""
    b, s = q.shape[:2]
    out = []
    for bi in range(b):
        rows = []
        for q0 in range(0, s, Q_BLOCK):
            q1 = min(s, q0 + Q_BLOCK)
            k0 = 0 if window is None else max(0, q0 - window + 1)
            args = (q[bi, q0:q1], k[bi, k0:q1], v[bi, k0:q1])
            if torch.is_grad_enabled():
                rows.append(checkpoint(_attend, *args, q0, k0, window, precision,
                                       use_reentrant=False))
            else:
                rows.append(_attend(*args, q0, k0, window, precision))
        out.append(torch.cat(rows))
    return torch.stack(out)


def _swiglu(x, wg, wu, wd, precision: str):
    c = lambda t: cast(t, precision)  # noqa: E731
    a = torch.nn.functional.silu(c(x) @ c(wg)) * (c(x) @ c(wu))
    return c(a) @ c(wd)


def _route(m: Model, z, router, selected, precision: str):
    s = torch.sigmoid(cast(z, precision) @ cast(router, precision))
    sel = torch.topk(s, m.k, dim=-1).indices if selected is None else selected.long()
    w = torch.gather(s, 1, sel)
    if m.route_norm:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return sel, w * m.route_scale


def _moe(m: Model, z, lay: dict, selected, precision: str, fault: Fault):
    sel, w = _route(m, z, lay["router"], selected, precision)
    lo = m.held[0] + fault.held_shift
    out = torch.zeros_like(z)
    for j in range(lay["we_gate"].shape[0]):
        tok, slot = torch.nonzero(sel == lo + j, as_tuple=True)
        if tok.numel():
            part = _swiglu(z[tok], lay["we_gate"][j], lay["we_up"][j], lay["we_down"][j],
                           precision)
            out = out.index_add(0, tok, part * w[tok, slot][:, None])
    for j in range(lay["ws_gate"].shape[0]):
        out = out + _swiglu(z, lay["ws_gate"][j], lay["ws_up"][j], lay["ws_down"][j], precision)
    return out, sel


def _layer_params(m: Model, params: dict, i: int) -> dict:
    out = {k: v[i] for k, v in params["layers"].items()}
    group, j = (("dense_layers", i) if i < m.dense_layers else ("moe_layers", i - m.dense_layers))
    out.update({k: v[j] for k, v in params[group].items()})
    return out


def _layer(m: Model, i: int, lay: dict, x, b: int, s: int, selected, precision: str,
           fault: Fault):
    """Layer i over x [B S, d]: (x out, the MoE's input and selection or
    None, None)."""
    c = lambda t: cast(t, precision)  # noqa: E731
    y = _rms(x, lay["attn_norm"], m.eps)
    q = (c(y) @ c(lay["wq"])).reshape(b, s, m.heads, m.dh)
    k = (c(y) @ c(lay["wk"])).reshape(b, s, m.kv_heads, m.dh)
    v = (c(y) @ c(lay["wv"])).reshape(b, s, m.kv_heads, m.dh)
    q, k = _rms(q, lay["q_norm"], m.eps), _rms(k, lay["k_norm"], m.eps)
    full = m.layer_types[i] == "full"
    if not full or fault.rope_on_full:
        q, k = _rope(q, m.theta), _rope(k, m.theta)
    window = None if full and not fault.window_on_full else m.window
    att = _attention(q, k, v, window, precision).reshape(b * s, m.heads * m.dh)
    att = att * torch.sigmoid(c(y) @ c(lay["wg"]))
    x = x + _rms(c(att) @ c(lay["wo"]), lay["post_attn_norm"], m.eps)
    z = _rms(x, lay["mlp_norm"], m.eps)
    if i < m.dense_layers:
        f, sel = _swiglu(z, lay["w_gate"], lay["w_up"], lay["w_down"], precision), None
    else:
        f, sel = _moe(m, z, lay, selected, precision, fault)
    return x + _rms(f, lay["post_mlp_norm"], m.eps), (None if sel is None else z), sel


def forward(m: Model, params: dict, tokens, *, routes=None, precision: str = "fp32",
            fault: Fault = NO_FAULT):
    """tokens [B, S] -> (every layer's input [B S, d] and the last layer's
    output, the MoE layers' inputs, their selections), without autograd.
    ``routes`` (a selection an MoE layer) is followed where given."""
    b, s = tokens.shape
    x = params["embed"][tokens.reshape(-1).long()] * math.sqrt(m.d)
    xs, inputs, sels = [], [], []
    with torch.no_grad():
        for i in range(m.layers):
            xs.append(x)
            given = None if routes is None or i < m.dense_layers else routes[len(sels)]
            x, z, sel = _layer(m, i, _layer_params(m, params, i), x, b, s, given, precision,
                               fault)
            if sel is not None:
                inputs.append(z)
                sels.append(sel)
    return xs + [x], inputs, sels


def _head(h, beta, actions, log_q, labels, precision: str):
    """(loss, ess, dLoss/dh) of the SNIS covariance surrogate over h [N,
    d], row blocks at a time (a row's weights need only its own draws)."""
    n = h.shape[0]
    valid = actions >= 0
    a = actions.clamp(min=0).long()
    rewards = ((a == labels.reshape(-1, 1)) & valid).float()
    loss, ess_sum, grads = 0.0, 0.0, []
    for r0 in range(0, n, HEAD_BLOCK):
        hb = h[r0:r0 + HEAD_BLOCK].detach().requires_grad_(True)
        with torch.enable_grad():
            emb = cast(beta[a[r0:r0 + HEAD_BLOCK]], precision)
            scores = torch.einsum("nd,nsd->ns", cast(hb, precision), emb)
            vb = valid[r0:r0 + HEAD_BLOCK]
            wbar = torch.softmax(scores.detach() - log_q[r0:r0 + HEAD_BLOCK], dim=-1) * vb
            rb = rewards[r0:r0 + HEAD_BLOCK]
            coeff = wbar * (rb - (wbar * rb).sum(dim=-1, keepdim=True))
            part = -torch.sum(coeff * scores) / n
            grads.append(torch.autograd.grad(part, hb)[0])
        loss += float(part.detach())
        denom = torch.sum(wbar**2, dim=-1)
        ess_sum += float(torch.where(denom > 0, 1.0 / denom.clamp(min=1e-30), 0.0).sum())
    return loss, ess_sum / n, torch.cat(grads)


def step(m: Model, fshape, params: dict, tokens, labels, beta, seed: int, *, topk=None,
         retrieve=None, routes=None, precision: str = "fp32", head_precision: str = "fp32",
         fault: Fault = NO_FAULT, leaves: dict = LEAVES) -> dict:
    """One FOPO-LM step at ``params`` (fp32) on tokens [B, S] with next
    tokens ``labels`` [B, S] (-1: none): loss, ESS, the final hidden
    states ``hidden`` [B S, d], the top-K drawn from (``topk``, else
    ``retrieve(hidden)``), the MoE inputs and selections, and the
    gradients of ``leaves`` by autograd."""
    b, s = tokens.shape
    xs, inputs, sels = forward(m, params, tokens, routes=routes, precision=precision,
                               fault=fault)
    x_last = xs[-1].detach().requires_grad_(True)
    with torch.enable_grad():
        h = _rms(x_last, params["final_norm"], m.eps)
    hd = h.detach()
    if topk is None:
        topk = retrieve(hd)
    actions, log_q = fopo_ref.mixture_draws(seed, topk[1], topk[0], fshape)
    loss, ess, g_h = _head(hd, beta, actions, log_q, labels, head_precision)
    g = torch.autograd.grad(h, x_last, g_h)[0]
    want = {name: path for name, path in leaves.items()}
    lowest = min(_leaf_layer(m, p) for p in want.values())
    grads = {}
    for i in range(m.layers - 1, lowest - 1, -1):
        lay = _layer_params(m, params, i)
        mine = {name: p for name, p in want.items() if _leaf_layer(m, p) == i}
        req = {}
        x_in = xs[i].detach().requires_grad_(True)
        given = None if i < m.dense_layers else sels[i - m.dense_layers]
        with torch.enable_grad():
            for name, p in mine.items():
                key = p[1]
                base = lay[key].detach()
                if len(p) > 3:  # one expert of the layer's stack
                    t = base[p[3]].clone().requires_grad_(True)
                    lay[key] = torch.cat([base[:p[3]], t[None], base[p[3] + 1:]])
                else:
                    t = lay[key] = base.clone().requires_grad_(True)
                req[name] = t
            out = _layer(m, i, lay, x_in, b, s, given, precision, fault)[0]
            gs = torch.autograd.grad(out, [x_in, *req.values()], g, allow_unused=True)
        g = gs[0]
        grads.update((name, torch.zeros_like(t) if gr is None else gr)
                     for (name, t), gr in zip(req.items(), gs[1:]))
    return {"loss": loss, "ess": ess, "hidden": hd, "topk": topk, "moe_inputs": inputs,
            "routes": sels, "grads": grads}


def adam_leaves(params: dict, grads: dict, m: dict, v: dict, t: int, lr: float,
                leaves: dict = LEAVES) -> dict:
    """The leaves after one step of the program's Adam (`fopo.adam_update`)
    from moments ``m``, ``v`` (by leaf name) at step count ``t``."""
    return {name: fopo_ref.adam_update(leaf(params, path), grads[name], m[name], v[name], t,
                                       lr)[0] for name, path in leaves.items()}


def route_gap(m: Model, router_layers, inputs, sels) -> float:
    """The largest shortfall of a recorded selection's j-th best score
    below the top-k's j-th, the scores s = sigmoid(z W_r) of the recorded
    MoE input z (absolute: s lies in (0, 1)); inf where a selection is
    not k distinct experts of the router."""
    gap = 0.0
    for router, z, sel in zip(router_layers, inputs, sels, strict=True):
        sel = sel.long()
        e = router.shape[-1]
        srt = torch.sort(sel, dim=1).values
        if (tuple(sel.shape) != (z.shape[0], m.k) or bool((sel < 0).any())
                or bool((sel >= e).any()) or bool((srt[:, 1:] == srt[:, :-1]).any())):
            return math.inf
        s = torch.sigmoid(z.float() @ router.float())
        best = torch.topk(s, m.k, dim=-1).values
        mine = torch.sort(torch.gather(s, 1, sel), dim=1, descending=True).values
        gap = max(gap, float((best - mine).max()))
    return gap
