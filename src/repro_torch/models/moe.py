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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["expert_ranks", "moe_capacity", "moe_ffn"]


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
