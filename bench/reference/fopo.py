"""The plain reference of a fopo-paper training step (arXiv:2208.05327,
Algorithm 1) with the paper's linear tower h = x W:

  1. h = x W
  2. the exact top-K of h beta^T over the whole catalog, sorted (or,
     on a route that retrieves otherwise, that route's top-K: the
     caller hands it in as ``retrieve``)
  3. S draws a context from q = eps/P + (1 - eps) softmax(top-K scores)
  4. rewards 1[a in Y]
  5. SNIS weights and the covariance gradient of the surrogate
     -mean_b sum_s c_bs f(a_bs), c = wbar (r - rbar) held fixed
  6. one Adam step

The draws are the counter-hash stream the configuration's in-kernel
sampler defines (a frozen copy of
`repro_torch/kernels/fused_sampler/ref.py`: splitmix32, the arm choice,
the Gumbel-argmax over the top-K slots, the uniform draw mod P, log q by
the reference package's logaddexp). Adam is a frozen copy of
`repro_torch/optim/optimizers.py:adam`'s update. Everything is computed
in row blocks, so that the [B, P] scores and the [B, S, K] Gumbel
noise are never held whole.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bench.reference.precision import cast
from bench.yardstick.gen import batch_rows

__all__ = ["FollowMismatch", "FopoShape", "adam_update", "mixture_draws", "reference_run",
           "step_loss_grad", "topk_exact"]

LOG_Q_PAD = 3.0e38  # a padded slot's log q (`repro_torch.constants`)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_GOLDEN, _MIX1, _MIX2, _M32 = 0x9E3779B9, 0x21F0AAAD, 0x735A2D97, 0xFFFFFFFF
_TINY = 1e-12


class FollowMismatch(ValueError):
    """A top-K to follow that does not cover the step's batch."""


@dataclasses.dataclass(frozen=True)
class FopoShape:
    num_items: int  # P
    embed_dim: int  # L
    num_samples: int  # S
    top_k: int  # K
    epsilon: float
    learning_rate: float
    sample_tile: int
    batch: int  # B


# -- the counter-hash sampler -------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_u32(seed: int, ctr: torch.Tensor) -> torch.Tensor:
    x = (_mul32(ctr, _GOLDEN) + (seed & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 15)


def _uniform01(seed: int, ctr: torch.Tensor) -> torch.Tensor:
    return (_hash_u32(seed, ctr) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    delta = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-delta.abs()))
    return torch.where(torch.isnan(delta), a + b, out)


def mixture_draws(seed: int, ids: torch.Tensor, scores: torch.Tensor, shape: FopoShape,
                  block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """(actions [B, Sp] int32, log q [B, Sp] float32) of the eps-mixture,
    Sp = S rounded up to the sample tile; padded slots get action -1 and
    log q LOG_Q_PAD."""
    b, k = ids.shape
    s, p = shape.num_samples, shape.num_items
    sp = -(-s // shape.sample_tile) * shape.sample_tile
    dev = ids.device
    eps = torch.full((), float(shape.epsilon), dtype=torch.float32, device=dev)
    pos = torch.arange(sp, dtype=torch.int64, device=dev)[None, :]
    m = scores.max(dim=-1, keepdim=True).values
    log_kappa = scores - (m + torch.log(torch.exp(scores - m).sum(dim=-1, keepdim=True)))
    log_u = torch.log(eps) - torch.log(torch.full((), float(p), device=dev))
    acts, logq = [], []
    for r0 in range(0, b, block):
        rid, rsc, rlk = ids[r0:r0 + block], scores[r0:r0 + block], log_kappa[r0:r0 + block]
        rows = torch.arange(r0, r0 + rid.shape[0], dtype=torch.int64, device=dev)[:, None]
        ctr0 = (((rows * sp + pos) & _M32) * (k + 2)) & _M32
        u_arm = _uniform01(seed, ctr0)
        bits_uni = _hash_u32(seed, (ctr0 + 1) & _M32)
        ctr_g = (ctr0[:, :, None] + 2 + torch.arange(k, dtype=torch.int64, device=dev)) & _M32
        gum = -torch.log(-torch.log(_uniform01(seed, ctr_g) + _TINY) + _TINY)
        slot = torch.argmax(rsc[:, None, :] + gum, dim=-1)
        del gum, ctr_g
        a = torch.where(u_arm < eps, (bits_uni % p).to(torch.int32), torch.gather(rid, 1, slot))
        hit = a[:, :, None] == rid[:, None, :]
        lk = torch.where(hit, rlk[:, None, :], 0.0).sum(dim=-1)
        mix = _logaddexp(log_u.expand_as(lk), torch.log1p(-eps) + lk)
        lq = torch.where(hit.any(dim=-1), mix, log_u)
        live = pos < s
        acts.append(torch.where(live, a, -1).to(torch.int32))
        logq.append(torch.where(live, lq, LOG_Q_PAD).to(torch.float32))
    return torch.cat(acts), torch.cat(logq)


# -- one step -------------------------------------------------------------------

def topk_exact(h: torch.Tensor, beta: torch.Tensor, k: int, precision: str,
               block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] descending, ids [B, K] int32): the exact top-K of
    h beta^T, in row blocks."""
    bt = cast(beta, precision).T
    vals, ids = [], []
    for r0 in range(0, h.shape[0], block):
        v, i = torch.topk(cast(h[r0:r0 + block], precision) @ bt, k, dim=1)
        vals.append(v)
        ids.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(ids)


def step_loss_grad(w: torch.Tensor, x: torch.Tensor, positives: torch.Tensor,
                   beta: torch.Tensor, seed: int, shape: FopoShape, precision: str,
                   block: int = 512, topk=None, retrieve=None) -> dict:
    """One step at parameters ``w`` on the batch (``x`` [B, L],
    ``positives`` [B, Y], -1 padded): its loss, dLoss/dW, ESS (the batch
    mean of 1 / sum wbar^2, 0 for a row with no live draw), h and the
    top-K (scores, ids) the draws came from. ``topk`` hands in the top-K
    to draw from in place of the step's own, which is ``retrieve(h)``
    (default: the exact top-K in ``precision``)."""
    h = cast(x, precision) @ cast(w, precision)
    if topk is None:
        topk = retrieve(h) if retrieve is not None else topk_exact(h, beta, shape.top_k,
                                                                   precision)
    top_s, top_i = topk
    actions, log_q = mixture_draws(seed, top_i, top_s, shape)
    valid = actions >= 0
    a = actions.clamp(min=0)
    rewards = ((a[:, :, None] == positives[:, None, :]).any(dim=-1) & valid).to(torch.float32)
    hq = cast(h, precision)
    scores = torch.cat([
        torch.einsum("bl,bsl->bs", hq[r0:r0 + block],
                     cast(beta[a[r0:r0 + block].long()], precision))
        for r0 in range(0, h.shape[0], block)])
    wbar = torch.softmax(scores - log_q, dim=-1) * valid
    rbar = torch.sum(wbar * rewards, dim=-1, keepdim=True)
    coeff = wbar * (rewards - rbar)
    loss = -torch.mean(torch.sum(coeff * scores, dim=-1))
    denom = torch.sum(wbar**2, dim=-1)
    ess = torch.mean(torch.where(denom > 0.0, 1.0 / denom.clamp(min=1e-30), 0.0))
    b = h.shape[0]
    cq = cast(torch.where(valid, coeff, 0.0), precision)
    g_h = torch.cat([
        torch.einsum("bs,bsl->bl", cq[r0:r0 + block],
                     cast(beta[a[r0:r0 + block].long()], precision))
        for r0 in range(0, b, block)]) * (-1.0 / b)
    return {"loss": float(loss), "grad": cast(x, precision).T @ cast(g_h, precision),
            "ess": float(ess), "h": h, "topk": (top_s, top_i)}


def adam_update(w, g, m, v, t: int, lr: float):
    """One Adam step of the program's form, u = (m mhat) / (sqrt(v vhat) + eps)."""
    m = ADAM_B1 * m + (1 - ADAM_B1) * g
    v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
    tt = torch.full((), float(t), dtype=torch.float32, device=w.device)
    mhat = 1.0 / (1.0 - torch.pow(torch.full((), ADAM_B1, device=w.device), tt))
    vhat = 1.0 / (1.0 - torch.pow(torch.full((), ADAM_B2, device=w.device), tt))
    u = (m * mhat) / (torch.sqrt(v * vhat) + ADAM_EPS)
    return w - lr * u, m, v


def reference_run(contexts: torch.Tensor, positives: torch.Tensor, beta: torch.Tensor,
                  w0: torch.Tensor, step_seed: Callable[[int], int], loader_seed: int,
                  shape: FopoShape, steps: int = 3, precision: str = "fp32",
                  follow: list | None = None, start: tuple | None = None, first_step: int = 0,
                  keep_rows: float = 1.0, frozen: bool = False, retrieve=None) -> dict:
    """``steps`` steps from ``w0`` with Adam's moments at zero, or from
    ``start`` = (W, m, v) before step number ``first_step`` (0-based: its
    batch, its step seed and Adam's count follow from it). Returns each
    step's loss, ESS and the top-K (scores, ids) its draws came from,
    each step's h and the top-K scores of that h (``exact``: the exact
    top-K's, or ``retrieve(h)``'s where the route retrieves otherwise),
    the first step's gradient as Adam's state after it holds it
    (m - b1 m_before) / (1 - b1), and the parameters at the start and
    after the last step.

    ``follow`` hands in each step's top-K as the program's retrieval gave
    it to its sampler: the steps then draw from those, so that near-equal
    scores ordered otherwise than here do not change the draws. Two
    faults can be planted, for the reference put in the program's place:
    ``keep_rows`` < 1 lets only that share of each batch's rows into the
    step, the mean taken over them; ``frozen`` returns the state unchanged
    from every step. ``retrieve`` (h -> (scores, ids)) is the route's own
    retrieval, in ``precision``; without it, the exact top-K."""
    if retrieve is None:
        def retrieve(h):
            return topk_exact(h, beta, shape.top_k, precision)
    n = contexts.shape[0]
    if start is None:
        w, m, v = w0.clone(), torch.zeros_like(w0), torch.zeros_like(w0)
    else:
        w, m, v = (t.clone() for t in start)
    out: dict = {"start": w.clone(), "losses": [], "ess": [], "topk": [], "h": [], "exact": []}
    for t in range(steps):
        k = first_step + t
        rows = torch.from_numpy(np.asarray(batch_rows(n, shape.batch, loader_seed, k)))
        rows = rows[:int(shape.batch * keep_rows)].to(contexts.device)
        given = follow[t] if follow is not None else None
        if given is not None and tuple(given[1].shape) != (len(rows), shape.top_k):
            raise FollowMismatch(f"step {k}: a top-K of {tuple(given[1].shape)} for "
                                 f"{len(rows)} rows")
        st = step_loss_grad(w, contexts[rows], positives[rows], beta, step_seed(k), shape,
                            precision, topk=given, retrieve=retrieve)
        out["h"].append(st["h"])
        out["exact"].append(retrieve(st["h"])[0] if given is not None else st["topk"][0])
        out["losses"].append(st["loss"])
        out["ess"].append(st["ess"])
        out["topk"].append(st["topk"])
        m_before = m
        if not frozen:
            w, m, v = adam_update(w, st["grad"], m, v, k + 1, shape.learning_rate)
        if t == 0:
            out["grad1"] = (m - ADAM_B1 * m_before) / (1.0 - ADAM_B1)
    out["params"] = w
    return out
