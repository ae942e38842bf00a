"""Self-normalised importance sampling (SNIS) under a softmax policy.

Given S proposal draws a_s ~ q(.|x) with unnormalised policy weights

    omega_s = exp(f_theta(a_s, x)) / q(a_s | x)
    wbar_s  = omega_s / sum_s' omega_s'

the SNIS estimate of E_{a~pi_theta}[g(a)] is sum_s wbar_s g(a_s), which
never touches the normalising constant Z_theta(x). All of it is done in
log space: log omega_s = f_s - log q_s, wbar = softmax(log omega).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "DIAGNOSTIC_KEYS",
    "SNISWeights",
    "effective_sample_size",
    "snis_covariance_coefficients",
    "snis_diagnostics",
    "snis_expectation",
    "snis_weights",
]


class SNISWeights(NamedTuple):
    wbar: torch.Tensor  # [B, S] normalised weights (sum to 1 over S)
    log_omega: torch.Tensor  # [B, S] unnormalised log weights
    ess: torch.Tensor  # [B] effective sample size 1 / sum wbar^2


def snis_weights(
    scores: torch.Tensor, log_q: torch.Tensor, valid: torch.Tensor | None = None
) -> SNISWeights:
    """scores = f_theta(a_s, x) [B, S]; log_q = log q(a_s|x) [B, S].

    ``valid`` (bool [B, S], optional) marks live sample slots: only the
    explicit mask makes a row with no live slot come out as all-zero
    weights instead of the uniform 1/S of a constant row's softmax."""
    log_omega = scores - log_q
    wbar = torch.softmax(log_omega, dim=-1)
    if valid is not None:
        wbar = wbar * valid
    return SNISWeights(wbar=wbar, log_omega=log_omega, ess=effective_sample_size(wbar))


def effective_sample_size(wbar: torch.Tensor) -> torch.Tensor:
    """1 / sum wbar^2 per row; a dead row (all-zero weights) reports 0,
    not the 1e30 a bare floor would give."""
    denom = torch.sum(wbar**2, dim=-1)
    return torch.where(denom > 0.0, 1.0 / denom.clamp(min=1e-30), 0.0)


def snis_expectation(wbar: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """E_pi[g] ~= sum_s wbar_s g(a_s). values: [B, S] or [B, S, D]."""
    if values.dim() == wbar.dim():
        return torch.sum(wbar * values, dim=-1)
    return torch.sum(wbar[..., None] * values, dim=-2)


# the aux-dict contract of snis_diagnostics: every estimator path
# returns these keys and the trainer logs them into history
DIAGNOSTIC_KEYS = ("ess", "rbar", "max_wbar")


def snis_diagnostics(wbar: torch.Tensor, rewards: torch.Tensor) -> dict:
    """Batch-mean monitoring scalars: ESS, the SNIS reward estimate rbar
    and the max normalised weight. Fully-masked rows contribute ESS 0.
    Keys are `DIAGNOSTIC_KEYS`."""
    return {
        "ess": torch.mean(effective_sample_size(wbar)),
        "rbar": torch.mean(torch.sum(wbar * rewards, dim=-1)),
        "max_wbar": torch.mean(torch.max(wbar, dim=-1).values),
    }


def snis_covariance_coefficients(wbar: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """c_s = wbar_s (r_s - rbar), so that Cov_pi[r, grad f] ~= sum_s c_s
    grad f_s (Algorithm 1's weights, what the surrogate loss uses)."""
    rbar = torch.sum(wbar * rewards, dim=-1, keepdim=True)
    return wbar * (rewards - rbar)
