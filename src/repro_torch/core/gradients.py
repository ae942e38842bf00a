"""Policy-gradient estimators.

Three estimators, in decreasing per-step cost:

  * `exact_objective`      dense sum over the catalog, O(P): ground truth
  * `reinforce_surrogate`  REINFORCE with exact sampling from pi_theta and
                           a leave-one-out baseline, O(P) (paper baseline)
  * `covariance_surrogate` the paper's estimator: SNIS + covariance
                           gradient, O(S K), catalog-size-free

and `covariance_gradient_dense_reference`, the O(P) gradient of
`exact_objective` that the tests and the gradient-quality comparison
hold the estimators to.

Each returns a scalar surrogate loss whose gradient (autograd) equals
minus the desired policy-gradient estimate. Coefficients inside the
surrogates are detached: Algorithm 1 evaluates the weights, it does not
differentiate them.

`covariance_surrogate(fused=True)` runs the fused kernels through
`FusedCovarianceLoss`, a `torch.autograd.Function`: the forward is the
scores-only covgrad kernel (the beta gather happens in the kernel, no
[B, S, L] tensor), then the weights, coefficients, loss and diagnostics
in plain torch, as the reference does them in jnp
(`repro/core/gradients.py:_fused_loss_pieces`); the backward is
g_scores = (-ct / B) * coeff, then the gather-reduce kernel for dL/dh.
beta, log_q and rewards get no gradient (Assumption 1).
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.core.snis import (
    DIAGNOSTIC_KEYS,
    snis_covariance_coefficients,
    snis_diagnostics,
    snis_weights,
)
from repro_torch.kernels.snis_covgrad.ops import (
    DEFAULT_SAMPLE_TILE,
    snis_covgrad_bwd,
    snis_scores_fused,
)
from repro_torch.optim.optimizers import value_and_grad

__all__ = [
    "FusedCovarianceLoss",
    "covariance_gradient_dense_reference",
    "covariance_surrogate",
    "exact_objective",
    "fused_covariance_loss",
    "reinforce_surrogate",
]


def exact_objective(
    policy: SoftmaxPolicy,
    params,
    x: torch.Tensor,  # [B, Dx]
    beta: torch.Tensor,  # [P, L]
    rewards_dense: torch.Tensor,  # [B, P] r_hat(a, x_i) for every action
) -> torch.Tensor:
    """R_hat = mean_i sum_a pi(a|x_i) r(a, x_i); loss = -R_hat."""
    log_pi = policy.log_probs(params, x, beta)  # [B, P]
    return -torch.mean(torch.sum(torch.exp(log_pi) * rewards_dense, dim=-1))


def covariance_gradient_dense_reference(
    policy: SoftmaxPolicy,
    params,
    x: torch.Tensor,
    beta: torch.Tensor,
    rewards_dense: torch.Tensor,  # [B, P]
):
    """O(P) closed form of the policy gradient for tests: the gradient of
    `exact_objective` (the loss -R_hat) with respect to ``params``, by
    `torch.autograd.grad`, as the reference's `jax.grad` gives it. By the
    covariance identity (Eq. 8) it is -Cov_pi[r, grad f], the negated
    covariance gradient the surrogates' gradients estimate; a tree shaped
    like ``params``."""
    return value_and_grad(
        lambda p: exact_objective(policy, p, x, beta, rewards_dense), params
    )[1]


def reinforce_surrogate(
    policy: SoftmaxPolicy,
    params,
    generator: torch.Generator,
    x: torch.Tensor,  # [B, Dx]
    beta: torch.Tensor,  # [P, L]
    reward_fn,  # actions [B, S] -> [B, S]
    num_samples: int,
) -> torch.Tensor:
    """grad = E_{a~pi}[(r - b) grad log pi(a|x)], leave-one-out baseline b."""
    with torch.no_grad():
        actions = policy.sample(generator, params, x, beta, num_samples)  # [B, S]
        rewards = reward_fn(actions)
    s = num_samples
    if s > 1:  # leave-one-out control variate
        baseline = (torch.sum(rewards, dim=-1, keepdim=True) - rewards) / (s - 1)
    else:
        baseline = torch.zeros_like(rewards)
    advantage = rewards - baseline
    log_pi = policy.log_probs(params, x, beta)  # [B, P]: the O(P) cost
    log_pi_a = torch.gather(log_pi, 1, actions)  # [B, S]
    return -torch.mean(torch.sum(advantage * log_pi_a, dim=-1) / s)


def covariance_surrogate(
    policy: SoftmaxPolicy,
    params,
    x: torch.Tensor,  # [B, Dx]
    beta: torch.Tensor,  # [P, L] (fixed: Assumption 1)
    actions: torch.Tensor,  # [B, S] proposal draws, -1 on masked slots
    log_q: torch.Tensor,  # [B, S] proposal log-pmf at the draws
    rewards: torch.Tensor,  # [B, S]
    *,
    fused: bool = False,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
    dist=None,
) -> tuple[torch.Tensor, dict]:
    """Surrogate whose gradient is the SNIS covariance gradient
    grad_theta = sum_s c_s grad_theta f_theta(a_s, x), with
    c_s = wbar_s (r_s - rbar) detached. Returns (loss, aux) with aux
    the `snis_diagnostics` dict.

    ``fused=True`` runs `fused_covariance_loss` (the kernels; gradients
    reach h only, beta is fixed). Masked slots (action -1, log_q
    LOG_Q_PAD) carry exactly zero weight in both paths, also in rows
    where every slot is masked.

    ``dist=DistConfig(...)`` runs the multi-device twin instead
    (`repro_torch.dist.fopo.dist_fused_covariance_loss`): the same fused
    kernels on this rank's beta slab (``beta``) and batch rows (``x`` and
    the samples), the score partials summed once over `model`."""
    if dist is not None:
        from repro_torch.dist.fopo import dist_fused_covariance_loss

        h = policy.user_embedding(params, x)
        return dist_fused_covariance_loss(
            h, beta, actions, log_q, rewards, dist=dist, sample_tile=sample_tile
        )
    if fused:
        h = policy.user_embedding(params, x)  # [B, L] differentiable
        return fused_covariance_loss(
            h, beta, actions, log_q, rewards, sample_tile=sample_tile
        )
    valid = actions >= 0
    scores = policy.scores_at(params, x, beta, actions.clamp(min=0))  # [B, S]
    w = snis_weights(scores.detach(), log_q, valid=valid)
    coeff = snis_covariance_coefficients(w.wbar, rewards).detach()
    loss = -torch.mean(torch.sum(coeff * scores, dim=-1))
    return loss, snis_diagnostics(w.wbar, rewards)


class FusedCovarianceLoss(torch.autograd.Function):
    """(loss, ess, rbar, max_wbar) of the fused step; the gradient flows
    to h only. Forward: the scores-only covgrad kernel, then the SNIS
    chain in plain torch. Backward: the gather-reduce kernel."""

    @staticmethod
    def forward(ctx, h, beta, actions, log_q, rewards, sample_tile):
        scores = snis_scores_fused(h, beta, actions, log_q, rewards, sample_tile=sample_tile)
        # exactly 0 on masked slots, also where every slot of a row is
        # masked (a bare softmax would hand that row 1/S)
        wbar = torch.softmax(scores - log_q, dim=-1) * (actions >= 0)
        coeff = snis_covariance_coefficients(wbar, rewards)
        loss = -torch.mean(torch.sum(coeff * scores, dim=-1))
        aux = snis_diagnostics(wbar, rewards)
        ctx.save_for_backward(coeff, actions, beta)
        ctx.sample_tile = sample_tile
        outs = (loss,) + tuple(aux[k] for k in DIAGNOSTIC_KEYS)
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, ct_loss, *_ct_aux):  # diagnostics' cotangents are discarded
        coeff, actions, beta = ctx.saved_tensors
        # per-sample score gradients dL/df; Algorithm 1 evaluates the SNIS
        # coefficients, it does not differentiate them
        g_scores = (-ct_loss / coeff.shape[0]) * coeff
        grad_h = snis_covgrad_bwd(g_scores, actions, beta, sample_tile=ctx.sample_tile)
        return grad_h, None, None, None, None, None


def fused_covariance_loss(
    h: torch.Tensor,  # [B, L] user embeddings (differentiable)
    beta: torch.Tensor,  # [P, L] fixed item embeddings
    actions: torch.Tensor,  # [B, S] int; -1 marks masked slots
    log_q: torch.Tensor,  # [B, S]; LOG_Q_PAD on masked slots
    rewards: torch.Tensor,  # [B, S]
    *,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
) -> tuple[torch.Tensor, dict]:
    """The fused FOPO step: (loss, aux) through `FusedCovarianceLoss`.
    beta is a fixed table: it gets no gradient, unlike the unfused path
    where autograd reaches beta too."""
    loss, *diag = FusedCovarianceLoss.apply(
        h, beta, actions, log_q.float(), rewards.float(), sample_tile
    )
    return loss, dict(zip(DIAGNOSTIC_KEYS, diag))
