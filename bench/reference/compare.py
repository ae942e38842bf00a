"""The numbers that decide `correct`: what the timed path produced, held
to what the reference works out from the same inputs. Each number is a
share, 0 where the two agree; the cell's limits are in
`bench/limits/<cell>.json`."""
from __future__ import annotations

import math

import torch

__all__ = ["TRAINING_NUMBERS", "retrieval_numbers", "training_numbers"]

TRAINING_NUMBERS = ("topk_score_err", "topk_rank_gap", "loss_gap", "ess_gap", "grad_gap",
                    "change_gap")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _worse(a: float, b: float) -> float:
    """The larger of two gaps; a gap that is not a number is infinite."""
    return math.inf if math.isnan(a) or math.isnan(b) else max(a, b)


def _topk_numbers(top: tuple, h: torch.Tensor, exact: torch.Tensor,
                  beta: torch.Tensor) -> tuple[float, float]:
    """(score error, rank gap) of a step's top-K (scores, ids) against the
    reference's h and its top-K scores at that step (the exact top-K's,
    or on the IVF route the reference's probe of its own index)."""
    p_s, p_i = top
    ids = p_i.to(torch.int64)
    if tuple(ids.shape) != tuple(exact.shape) or bool(((ids < 0) | (ids >= beta.shape[0])).any()):
        return math.inf, math.inf
    true = torch.einsum("bl,bkl->bk", h, beta[ids])
    scale = exact[:, :1].abs().clamp(min=1e-30)
    score_err = float(((p_s - true).abs() / scale).max())
    mine = torch.sort(true, dim=1, descending=True).values
    return score_err, float(((exact - mine) / scale).clamp(min=0).max())


def training_numbers(segments: list[tuple[dict, dict]], beta: torch.Tensor) -> dict:
    """A training cell's numbers over runs of followed steps, each a pair
    (the program's, the reference's): the first from theta0, the others
    from the program's state inside the window. Each number is the worst
    over every step of every run:

    topk_score_err  each step's retrieval by itself: the largest
                    |score - h . item| over its top-K slots, h the
                    reference's, over the row's exact top score
    topk_rank_gap   the largest shortfall of its j-th best true score
                    below the reference's j-th (its exact top-K, or its
                    IVF probe on that route), over the same scale
    loss_gap        the largest |loss - loss_ref| / |loss_ref|
    ess_gap         the largest relative gap of the SNIS effective sample
                    size (the step's batch-mean ESS)
    grad_gap        | |g1| - |g1_ref| | / |g1_ref| of the first run's first
                    gradient, as Adam's state after it holds it
    change_gap      | |W - W_s| - |W_ref - W_s| | / |W_ref - W_s| after
                    each run's steps, W_s the parameters it started from

    The program's side holds ``losses``, ``ess``, ``topk`` (each step's
    scores and ids), ``start`` and ``params`` (W before and after the
    run) and in the first run ``grad1``; the reference's also ``h`` and
    ``exact`` for each step. The linear tower has one leaf, so its norm
    is also the median leaf's."""
    score_err = rank_gap = loss_gap = ess_gap = change_gap = 0.0
    for prog, ref in segments:
        for top, h, exact in zip(prog["topk"], ref["h"], ref["exact"], strict=True):
            e, g = _topk_numbers(top, h, exact, beta)
            score_err, rank_gap = _worse(score_err, e), _worse(rank_gap, g)
        for a, b in zip(prog["losses"], ref["losses"], strict=True):
            loss_gap = _worse(loss_gap, _rel(a, b))
        for a, b in zip(prog["ess"], ref["ess"], strict=True):
            ess_gap = _worse(ess_gap, _rel(a, b))
        change_ref = _norm(ref["params"] - prog["start"])
        change = _norm(prog["params"] - prog["start"])
        change_gap = _worse(change_gap, abs(change - change_ref) / max(change_ref, 1e-30))
    first_prog, first_ref = segments[0]
    return {
        "topk_score_err": score_err,
        "topk_rank_gap": rank_gap,
        "loss_gap": loss_gap,
        "ess_gap": ess_gap,
        "grad_gap": _worse(0.0, _rel(_norm(first_prog["grad1"]), _norm(first_ref["grad1"]))),
        "change_gap": change_gap,
    }


def retrieval_numbers(ids: torch.Tensor, scores: torch.Tensor, answered: torch.Tensor,
                      u_ref: torch.Tensor, items: torch.Tensor, ref_ids: torch.Tensor,
                      ref_scores: torch.Tensor) -> dict:
    """A retrieval cell's three numbers over the judged users (rows):

    missing    answers not there: a user with no answer, a slot with no id
               (or an id off the table, or a repeat) where the reference
               has an item
    score_err  the largest |score - u_ref . item| over the answer's slots,
               over the user's reference top score
    rank_gap   the largest shortfall of the answer's j-th best true score
               below the reference's j-th best, over the same scale

    ``ids`` / ``scores`` [n, K] are the program's, ``answered`` [n] bool;
    ``u_ref`` the reference's queries, ``ref_ids`` / ``ref_scores`` its
    answers (-1 ids where fewer than K items were probed)."""
    n, k = ref_ids.shape
    p = items.shape[0]
    ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < p)
    srt = torch.sort(torch.where(ok, ids, -1 - torch.arange(k, device=ids.device)), dim=1).values
    dup = torch.zeros_like(ok)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    ref_live = ref_ids >= 0
    short = (ref_live.sum(dim=1) - ok.sum(dim=1) + dup.sum(dim=1)).clamp(min=0)
    missing = int(torch.where(answered, short, k).sum())
    s_true = torch.einsum("nl,nkl->nk", u_ref, items[ids.clamp(0, p - 1)])
    scale = ref_scores[:, :1].abs().clamp(min=1e-30)
    live = ok & answered[:, None]
    err = torch.where(live, (scores - s_true).abs() / scale, 0.0)
    mine = torch.sort(torch.where(live, s_true, -1e30), dim=1, descending=True).values
    gap = torch.where(ref_live & answered[:, None], (ref_scores - mine) / scale, 0.0)
    gap = torch.nan_to_num(gap, posinf=1e30)
    return {
        "missing": missing,
        "score_err": float(err.max()) if n else 0.0,
        "rank_gap": float(gap.clamp(min=0).max()) if n else 0.0,
    }
