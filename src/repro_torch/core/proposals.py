"""Proposal distributions q(.|x) for self-normalised importance sampling.

The paper's proposal is the mixture

    q_{K,eps}(a|x) = eps/P + (1-eps) * kappa(a|x)        if a in topK(x)
                   = eps/P                               otherwise

where kappa is the softmax of the policy scores restricted to the top-K
actions retrieved by MIPS. Everything works on a batch of contexts: the
top-K sets are [B, K] index/score tensors from any retriever. All ops
are O(S + K), never O(P). Draws come from a `torch.Generator`; the
reference draws from `jax.random`, so the two agree in distribution,
and `log_prob` agrees exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.policy import gumbel

__all__ = ["MixtureProposal", "ProposalSample", "UniformProposal", "adaptive_epsilon"]


class ProposalSample(NamedTuple):
    """S draws per context plus everything SNIS needs to weight them."""

    actions: torch.Tensor  # [B, S] int32 global item ids
    log_q: torch.Tensor  # [B, S] float32 log q(a_s | x)
    topk_slot: torch.Tensor  # [B, S] int32 slot in the top-K list, -1 off it


def _eps_tensor(epsilon, device) -> torch.Tensor:
    if isinstance(epsilon, torch.Tensor):
        return epsilon.to(device=device, dtype=torch.float32)
    return torch.full((), float(epsilon), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class MixtureProposal:
    """q_{K,eps}: eps-mixture of uniform(P) and softmax-over-top-K.

    ``epsilon`` may be a float or a 0-d tensor (an adaptive schedule);
    both take the same code route."""

    num_items: int
    epsilon: float | torch.Tensor

    def log_prob(
        self,
        actions: torch.Tensor,  # [B, S]
        topk_indices: torch.Tensor,  # [B, K]
        topk_scores: torch.Tensor,  # [B, K]
    ) -> torch.Tensor:
        """log q(a|x) for arbitrary actions. O(S K) membership check."""
        eps = _eps_tensor(self.epsilon, topk_scores.device)
        log_kappa_full = torch.log_softmax(topk_scores, dim=-1)  # [B, K]
        hit = actions[:, :, None] == topk_indices[:, None, :]  # [B, S, K]
        in_topk = hit.any(dim=-1)
        # exactly one hit per row (top-k ids are distinct), so a 0-filled
        # masked sum selects it
        log_kappa = torch.where(
            in_topk,
            torch.where(hit, log_kappa_full[:, None, :], 0.0).sum(dim=-1),
            -torch.inf,
        )
        log_uniform = torch.log(eps) - _log_num_items(self.num_items, eps.device)
        if isinstance(self.epsilon, float) and self.epsilon >= 1.0:
            return log_uniform.expand(actions.shape).clone()
        log_mix_topk = torch.logaddexp(log_uniform, torch.log1p(-eps) + log_kappa)
        return torch.where(in_topk, log_mix_topk, log_uniform)

    def sample(
        self,
        generator: torch.Generator,
        topk_indices: torch.Tensor,  # [B, K]
        topk_scores: torch.Tensor,  # [B, K]
        num_samples: int,
    ) -> ProposalSample:
        """Draw S actions per context from the mixture. O(S log K)."""
        batch, k = topk_indices.shape
        dev = topk_scores.device
        eps = _eps_tensor(self.epsilon, dev)
        uni_arm = torch.rand((batch, num_samples), generator=generator, device=dev) < eps
        uniform_draw = torch.randint(
            0, self.num_items, (batch, num_samples), generator=generator, device=dev,
            dtype=torch.int32,
        )
        # kappa arm: categorical over the K scores (Gumbel argmax, K small)
        g = gumbel((batch, num_samples, k), generator, dev)
        slot = torch.argmax(topk_scores[:, None, :] + g, dim=-1)
        kappa_draw = torch.gather(topk_indices, 1, slot).to(torch.int32)
        actions = torch.where(uni_arm, uniform_draw, kappa_draw)
        log_q = self.log_prob(actions, topk_indices, topk_scores)
        topk_slot = torch.where(uni_arm, -1, slot).to(torch.int32)
        return ProposalSample(actions=actions, log_q=log_q, topk_slot=topk_slot)


def _log_num_items(num_items: int, device) -> torch.Tensor:
    """log P taken in float32, as the reference takes it."""
    return torch.log(torch.full((), float(num_items), dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class UniformProposal:
    """The eps == 1 degenerate case: q = U({1..P})."""

    num_items: int

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        return (-_log_num_items(self.num_items, actions.device)).expand(actions.shape).clone()

    def sample(
        self, generator: torch.Generator, batch: int, num_samples: int, device=None
    ) -> ProposalSample:
        dev = device if device is not None else generator.device
        actions = torch.randint(
            0, self.num_items, (batch, num_samples), generator=generator, device=dev,
            dtype=torch.int32,
        )
        return ProposalSample(
            actions=actions,
            log_q=self.log_prob(actions),
            topk_slot=torch.full((batch, num_samples), -1, dtype=torch.int32, device=dev),
        )


def adaptive_epsilon(
    step: int | torch.Tensor, total_steps: int, eps_start: float = 1.0, eps_end: float = 0.1
) -> torch.Tensor:
    """The conclusion's suggestion, eps evolving during training (uniform
    early, top-K heavy late): a cosine schedule from eps_start to
    eps_end, as a 0-d float32 tensor."""
    t = torch.clamp(torch.as_tensor(step, dtype=torch.float32) / max(total_steps, 1), 0.0, 1.0)
    return eps_end + 0.5 * (eps_start - eps_end) * (1.0 + torch.cos(math.pi * t))
