"""Reward estimators r_hat(a, x) (paper, Introduction).

A RewardFn maps a batch of sampled actions [B, S] to rewards [B, S]:

  * binary session completion  r_hat(a, x_i) = 1[a in Y_i]
  * IPS / clipped IPS          r_i / max(tau, p_i) * 1[a == a_i]
  * doubly robust (DR)         (r_i - r_M(a_i, x_i)) / max(tau, p_i)
                                 * 1[a == a_i] + r_M(a, x_i)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import torch

__all__ = [
    "LoggedFeedback",
    "RewardModel",
    "make_dot_reward_model",
    "make_dr_reward",
    "make_ips_reward",
    "make_session_reward",
]

RewardFn = Callable[[torch.Tensor], torch.Tensor]  # actions [B,S] -> rewards [B,S]


def make_session_reward(positives: torch.Tensor) -> RewardFn:
    """positives: [B, Y_max] padded with -1. r(a) = 1[a in Y]."""

    def reward(actions: torch.Tensor) -> torch.Tensor:
        hit = actions[:, :, None] == positives[:, None, :]  # [B, S, Ymax]
        return hit.any(dim=-1).to(torch.float32)

    return reward


@dataclasses.dataclass(frozen=True)
class LoggedFeedback:
    """One logged (action, propensity, reward) triple per context."""

    actions: torch.Tensor  # [B] int
    propensities: torch.Tensor  # [B] float32, logging policy pi_0(a_i|x_i)
    rewards: torch.Tensor  # [B] float32


def make_ips_reward(logged: LoggedFeedback, tau: float = 0.0) -> RewardFn:
    """Clipped IPS (tau=0 -> vanilla IPS / Horvitz-Thompson)."""
    scale = logged.rewards / logged.propensities.clamp(min=tau)  # [B]

    def reward(actions: torch.Tensor) -> torch.Tensor:
        match = actions == logged.actions[:, None]  # [B, S]
        return torch.where(match, scale[:, None], 0.0)

    return reward


class RewardModel(Protocol):
    def __call__(self, actions: torch.Tensor) -> torch.Tensor:
        """r_M(a, x_i) for actions [B, S] -> [B, S]."""


def make_dr_reward(
    logged: LoggedFeedback, reward_model: RewardModel, tau: float = 0.0
) -> RewardFn:
    """Doubly robust (clipped): the model everywhere plus the
    IPS-corrected residual at the logged action."""
    denom = logged.propensities.clamp(min=tau)

    def reward(actions: torch.Tensor) -> torch.Tensor:
        base = reward_model(actions)  # [B, S]
        logged_model = reward_model(logged.actions[:, None])[:, 0]  # [B]
        residual = (logged.rewards - logged_model) / denom  # [B]
        match = actions == logged.actions[:, None]
        return base + torch.where(match, residual[:, None], 0.0)

    return reward


def make_dot_reward_model(
    item_embeddings: torch.Tensor, user_vectors: torch.Tensor, scale: float = 1.0
) -> RewardModel:
    """A bilinear reward model r_M(a, x_i) = sigma(u_i . beta_a)."""

    def model(actions: torch.Tensor) -> torch.Tensor:
        emb = item_embeddings[actions.long()]  # [B, S, L]
        logits = torch.einsum("bl,bsl->bs", user_vectors, emb) * scale
        return (1.0 / (1.0 + torch.exp(-logits))).to(torch.float32)

    return model
