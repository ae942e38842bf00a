"""Mixture-of-experts FFN (the reference's `repro/models/moe.py`): top-k
routing, a capacity-bucketed scatter dispatch, batched expert matmuls
and a gather combine, with the Switch load-balancing loss.

The layout is the reference's: a dense [E, C, d] capacity buffer, so
each expert's product is one fixed-shape batched matmul (`torch.bmm`),
and tokens past an expert's capacity are dropped (GShard semantics).
What decides the numbers, each as the reference does it:

* the capacity is ``max(1, int(t * k * capacity_factor / e))`` in Python
  arithmetic over the ``t`` tokens of this call;
* the router runs in fp32 and the top-k probabilities are renormalised
  in fp32;
* an assignment's rank within its expert counts the assignments to that
  expert before it in token-major order (token 0's k experts, then token
  1's, ...): that order decides which tokens overflow. The reference
  takes it as the cumsum of a one-hot [T k, E]; here a stable sort by
  expert gives the same integers (a scan down the one-hot's T k rows
  took ~47 ms a layer at OLMoE's prefill on the H100);
* the dispatch accumulates. A dropped assignment has its source zeroed
  and is clamped to slot ``capacity - 1``, which a kept token may own, so
  it adds exactly zero there (`index_add` into the flattened [E C, d]
  buffer; an indexed assignment would overwrite the kept token). Only
  zeros meet a kept row, so the order of the adds, undefined on CUDA,
  changes no bit;
* the combine weight ``keep * top_p`` is cast to the activations' dtype
  before it multiplies them;
* the aux loss's routed fraction counts every assignment, kept or not.

`afmoe_moe` is AFMoE's layer (Trinity), dropless, beside it: sigmoid
scores in fp32, the top-k of them chosen (the expert bias held at zero),
the chosen scores summed to 1 (``route_norm``) and scaled, one shared
SwiGLU expert on every token. The layer is told which routed experts
its device holds (``held`` = [lo, hi)): it routes over all of them and
computes only the held experts' weighted part plus the shared expert;
the devices holding the others add theirs. Its products are one grouped
product a projection (`torch._grouped_mm`) over the held assignments
sorted by expert, then the shared expert's rows: the group offsets stay
on the device (no `.item()`, no host sync), so the rows of every
assignment are laid out, and the rows of experts held elsewhere, sorted
past the last offset, are never multiplied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.obs import trace as _trace

__all__ = ["afmoe_experts", "afmoe_moe", "afmoe_route", "expert_ranks", "moe_capacity",
           "moe_ffn"]

MOE_ROWS_FIELDS = ("tokens", "held_rows", "max_expert_rows")  # a pass of `moe.rows`


def moe_capacity(tokens: int, k: int, capacity_factor: float, num_experts: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens."""
    return max(1, int(tokens * k * capacity_factor / num_experts))


def expert_ranks(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[N] expert ids in token-major order -> [N] int64: how many earlier
    entries chose the same expert (the reference's cumsum of a one-hot,
    minus one), through a stable sort by expert."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    # the count of each expert (a bincount, written with a fixed-size output)
    counts = flat_e.new_zeros(num_experts).index_add(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts  # first sorted slot of each expert
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=flat_e.device) - starts[flat_e[order]]
    return ranks


def moe_ffn(
    x: torch.Tensor,  # [T, d] flattened tokens
    router_w: torch.Tensor,  # [d, E]
    we_gate: torch.Tensor,  # [E, d, f]
    we_up: torch.Tensor,  # [E, d, f]
    we_down: torch.Tensor,  # [E, f, d]
    *,
    num_experts_per_tok: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
) -> tuple[torch.Tensor, dict]:
    """(out [T, d] in x's dtype, {"aux_loss", "dropped_frac"}: 0-dim fp32)."""
    t, d = x.shape
    e = router_w.shape[-1]
    k = num_experts_per_tok
    capacity = moe_capacity(t, k, capacity_factor, e)

    logits = x.float() @ router_w.float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [T, k], descending
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalise

    flat_e = top_e.reshape(-1)  # [T*k], token-major
    pos = expert_ranks(flat_e, e)
    keep = pos < capacity
    safe_pos = pos.clamp(max=capacity - 1)

    src = x.repeat_interleave(k, dim=0)  # [T*k, d]: token i's row k times in a row
    src = torch.where(keep[:, None], src, torch.zeros((), dtype=x.dtype, device=x.device))
    slot = flat_e * capacity + safe_pos  # [T*k] row of the flattened [E*C, d] buffer
    buf = x.new_zeros((e * capacity, d)).index_add(0, slot, src).view(e, capacity, d)

    h_g = torch.bmm(buf, we_gate)  # [E, C, f]
    h_u = torch.bmm(buf, we_up)
    a = F.silu(h_g) if act == "silu" else F.gelu(h_g, approximate="tanh")
    out_buf = torch.bmm(a * h_u, we_down)  # [E, C, d]

    # the combine gather; its backward adds into the slots, where a dropped
    # assignment's zero weight again adds exactly zero
    gathered = out_buf.reshape(e * capacity, d).index_select(0, slot)  # [T*k, d]
    weight = (keep[:, None] * top_p.reshape(-1)[:, None]).to(gathered.dtype)
    out = (gathered * weight).reshape(t, k, d).sum(dim=1)

    # load-balancing aux (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)  # [E] mean router probability
    ce = F.one_hot(top_e, e).float().sum(dim=1).mean(dim=0)  # [E] fraction routed
    aux_loss = e * torch.sum(me * ce)
    dropped = 1.0 - keep.float().mean()
    return out, {"aux_loss": aux_loss, "dropped_frac": dropped}


# ---------------------------------------------------------------------------
# AFMoE: dropless sigmoid routing, held experts, a shared expert
# ---------------------------------------------------------------------------

def afmoe_route(x: torch.Tensor, router_w: torch.Tensor, *, k: int, route_norm: bool,
                route_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d], router_w [d, E] -> (selected [T, k] int64, weights [T, k]
    fp32): s = sigmoid(x W_r) in fp32, the top-k of s (the expert bias is
    held at zero), their scores over their sum + 1e-20 when
    ``route_norm``, times ``route_scale``."""
    s = torch.sigmoid(x.float() @ router_w.float())
    sel = torch.topk(s, k, dim=-1).indices
    w = torch.gather(s, 1, sel)
    if route_norm:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return sel, w * route_scale


class _CountBackward(torch.autograd.Function):
    """The identity; its backward adds ``stats`` to the ambient tracer's
    ``moe.rows`` buffer, after the forward passes' fields."""

    @staticmethod
    def forward(ctx, x, stats):
        ctx.stats = stats
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        buf = _trace.device_counters("moe.rows", 2 * len(MOE_ROWS_FIELDS), ctx.stats.device)
        if buf is not None:
            buf[len(MOE_ROWS_FIELDS):] += ctx.stats
        return g, None


def afmoe_experts(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                  we_gate: torch.Tensor, we_up: torch.Tensor, we_down: torch.Tensor,
                  ws_gate: torch.Tensor, ws_up: torch.Tensor, ws_down: torch.Tensor,
                  *, held: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """(the held experts' weighted outputs plus the shared experts', [T, d]
    in x's dtype; each held expert's rows [H] int64). x [T, d]; sel /
    weights [T, k] from `afmoe_route`; we_* [H, d, f] / [H, f, d] the held
    experts [lo, lo + H); ws_* [N, d, f] / [N, f, d] the shared ones. Each
    token's rows are summed in fp32 and rounded once, in a fixed order."""
    t, d = x.shape
    k = sel.shape[1]
    n_held, n_shared = we_gate.shape[0], ws_gate.shape[0]
    lo = held[0]
    local = sel.reshape(-1) - lo
    is_held = (local >= 0) & (local < n_held)
    # the groups: held experts 0..H-1, then the shared experts; assignments
    # to experts held elsewhere sort past the last group
    key = torch.cat([torch.where(is_held, local, n_held + n_shared),
                     torch.arange(n_shared, device=x.device).repeat_interleave(t) + n_held])
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(n_held + n_shared + 1, dtype=torch.int64, device=x.device).index_add_(
        0, key, torch.ones_like(key))
    offs = torch.cumsum(counts[:-1], 0).to(torch.int32)
    live = torch.cat([is_held, is_held.new_ones(n_shared * t)])
    rows = torch.cat([x[:, None, :].expand(t, k, d).reshape(t * k, d),
                      x[None].expand(n_shared, t, d).reshape(n_shared * t, d)])[order]
    # the rows no group reads take no gradient (the products leave theirs unset)
    rows = torch.where(live[order, None], rows, rows.detach())
    w_g, w_u, w_d = (torch.cat([a, b]) for a, b in
                     ((we_gate, ws_gate), (we_up, ws_up), (we_down, ws_down)))
    g = torch._grouped_mm(rows, w_g, offs=offs)
    u = torch._grouped_mm(rows, w_u, offs=offs)
    y = torch._grouped_mm(F.silu(g) * u, w_d, offs=offs)
    y = torch.zeros_like(y).index_copy(0, order, y)  # back to the assignments' order
    # the unmultiplied rows hold whatever their memory held: zeroed before
    # anything (a weight's gradient among them) reads them
    y = torch.where(live[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    scale = torch.cat([weights.reshape(-1), weights.new_ones(n_shared * t)]).to(y.dtype)
    y = y * scale[:, None]
    routed = y[:t * k].reshape(t, k, d)
    shared = y[t * k:].reshape(n_shared, t, d).transpose(0, 1)
    return torch.cat([routed, shared], dim=1).sum(dim=1), counts[:n_held]


def afmoe_moe(x: torch.Tensor, layer: dict, *, k: int, route_norm: bool, route_scale: float,
              held: tuple[int, int], record: list | None = None) -> torch.Tensor:
    """AFMoE's layer over x [T, d]: `afmoe_route` over the router's every
    expert, then `afmoe_experts` over the held ones and the shared ones.
    ``layer`` holds `router`, `we_gate` / `we_up` / `we_down` and `ws_gate`
    / `ws_up` / `ws_down`. With a tracer active it adds the pass's tokens,
    held assignments and the most loaded held expert's rows to the
    ``moe.rows`` device counter (`MOE_ROWS_FIELDS`, then the same for the
    backward passes); nothing is read back. ``record`` gets the selection
    appended."""
    with _trace.span("moe_route"):
        sel, w = afmoe_route(x, layer["router"], k=k, route_norm=route_norm,
                             route_scale=route_scale)
    if record is not None:
        record.append(sel)
    with _trace.span("moe_experts"):
        out, per_expert = afmoe_experts(
            x, sel, w, layer["we_gate"], layer["we_up"], layer["we_down"], layer["ws_gate"],
            layer["ws_up"], layer["ws_down"], held=held)
    tracer = _trace.current()
    if tracer is not None:
        stats = torch.stack([torch.full((), x.shape[0], dtype=torch.int64, device=x.device),
                             per_expert.sum(), per_expert.max()])
        buf = tracer.device_counters("moe.rows", 2 * len(MOE_ROWS_FIELDS), x.device)
        buf[:len(MOE_ROWS_FIELDS)] += stats
        if out.requires_grad:
            out = _CountBackward.apply(out, stats)
    return out
