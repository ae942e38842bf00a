"""FOPO-LM: the paper's estimator over an LM vocabulary head (the
reference's `repro/core/lm_head.py`).

A reward-driven next-token objective J = E_t E_{a ~ pi(.|h_t)} [r(a, t)]
has the same O(V) softmax as the paper's catalog. Its gradient is
estimated with the SNIS covariance gradient and the top-K + uniform
mixture proposal, where the "item embeddings" are the output-embedding
rows, frozen (Assumption 1). The loss works on hidden states, so any
backbone (`repro_torch.models.lm`) can call it on its final ones.

The draws come from a `torch.Generator` seeded with ``seed`` (the
reference's from a JAX key: equal in distribution only); ``sample=``
hands the loss another run's draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.proposals import MixtureProposal, ProposalSample
from repro_torch.core.snis import snis_covariance_coefficients, snis_weights
from repro_torch.mips.exact import topk_exact
from repro_torch.mips.streaming import topk_streaming

__all__ = ["FopoLMHeadConfig", "fopo_lm_head_loss"]


@dataclasses.dataclass(frozen=True)
class FopoLMHeadConfig:
    """The reference's fields and defaults."""

    vocab_size: int
    num_samples: int = 256  # S
    top_k: int = 128  # K
    epsilon: float = 0.5
    retriever: str = "streaming"
    block_items: int = 8192


def fopo_lm_head_loss(
    hidden: torch.Tensor,  # [N, D] flattened (batch * seq) hidden states
    out_embed: torch.Tensor,  # [V, D] the frozen output embedding
    token_rewards,  # actions [N, S] -> rewards [N, S]
    seed: int,
    cfg: FopoLMHeadConfig,
    *,
    sample: ProposalSample | None = None,
) -> tuple[torch.Tensor, dict]:
    """(surrogate loss, {"ess"}), O(N (K + S) D): its gradient in
    ``hidden`` is the SNIS covariance gradient."""
    out_embed = out_embed.detach()
    if sample is None:
        h_prop = hidden.detach()
        if cfg.retriever == "exact":
            topk = topk_exact(h_prop, out_embed, cfg.top_k)
        else:
            topk = topk_streaming(h_prop, out_embed, cfg.top_k, cfg.block_items)
        gen = torch.Generator(device=hidden.device).manual_seed(seed)
        sample = MixtureProposal(cfg.vocab_size, cfg.epsilon).sample(
            gen, topk.indices, topk.scores, cfg.num_samples
        )
    rewards = token_rewards(sample.actions).detach()
    # differentiable scores of the sampled tokens
    emb = out_embed[sample.actions.long()]  # [N, S, D]
    scores = torch.einsum("nd,nsd->ns", hidden, emb)
    w = snis_weights(scores.detach(), sample.log_q)
    coeff = snis_covariance_coefficients(w.wbar, rewards).detach()
    loss = -torch.mean(torch.sum(coeff * scores, dim=-1))
    return loss, {"ess": torch.mean(w.ess)}
