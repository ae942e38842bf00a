"""Softmax policies over large discrete action spaces.

pi_theta(a|x) = exp(f_theta(a, x)) / Z_theta(x) with the MIPS-compatible
bilinear form f_theta(a, x) = h_theta(x)^T beta_a. beta is the fixed item
table (Assumption 1), passed explicitly; h_theta is the trainable user
tower, a function of (params, x) over a plain dict of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = [
    "SoftmaxPolicy",
    "linear_tower_apply",
    "linear_tower_init",
    "make_linear_policy",
    "make_mlp_policy",
    "mlp_tower_apply",
    "mlp_tower_init",
]

Params = Any
Tower = Callable[[Params, torch.Tensor], torch.Tensor]


def linear_tower_init(
    generator: torch.Generator, dim_in: int, dim_out: int, device=None
) -> Params:
    """theta in R^{L x L} as in the paper: h_theta(x) = theta^T x, with
    N(0, 1 / dim_in) entries drawn from ``generator`` (whose device the
    tensor is made on unless ``device`` says otherwise)."""
    dev = device if device is not None else generator.device
    w = torch.randn((dim_in, dim_out), generator=generator, device=dev)
    return {"w": w * (1.0 / math.sqrt(dim_in))}


def linear_tower_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def mlp_tower_init(generator: torch.Generator, dims: tuple[int, ...], device=None) -> Params:
    """A small MLP tower: dims = (in, h1, ..., out), He-scaled weights,
    zero biases."""
    dev = device if device is not None else generator.device
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator, device=dev)
        layers.append({
            "w": w * math.sqrt(2.0 / d_in),
            "b": torch.zeros((d_out,), device=dev),
        })
    return {"layers": layers}


def mlp_tower_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x
    layers = params["layers"]
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if i + 1 < len(layers):
            h = torch.relu(h)
    return h


@dataclasses.dataclass(frozen=True)
class SoftmaxPolicy:
    """pi_theta(a|x) = softmax_a(h_theta(x)^T beta_a).

    `tower` maps (params, x [B, Dx]) -> h [B, L]; `item_dim` == L. beta
    is not stored here: it is passed explicitly."""

    tower: Tower
    item_dim: int

    def user_embedding(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.tower(params, x)

    def scores(self, params: Params, x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """Full score matrix f_theta(., x) of shape [B, P]. O(P): small P only."""
        return self.user_embedding(params, x) @ beta.T

    def scores_at(
        self, params: Params, x: torch.Tensor, beta: torch.Tensor, actions: torch.Tensor
    ) -> torch.Tensor:
        """f_theta(a_s, x) for sampled actions [B, S] -> [B, S]. O(S L)."""
        h = self.user_embedding(params, x)  # [B, L]
        return torch.einsum("bl,bsl->bs", h, beta[actions.long()])

    def log_probs(self, params: Params, x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """Full log pi_theta(.|x) [B, P]. O(P): baselines and tests."""
        return torch.log_softmax(self.scores(params, x, beta), dim=-1)

    def argmax_action(self, params: Params, x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """Greedy decision rule a*_x = argmax_a f_theta(a, x) (Eq. 5), dense."""
        return torch.argmax(self.scores(params, x, beta), dim=-1)

    def sample(
        self,
        generator: torch.Generator,
        params: Params,
        x: torch.Tensor,
        beta: torch.Tensor,
        num_samples: int,
    ) -> torch.Tensor:
        """Exact sampling from pi_theta, O(P) by the Gumbel trick: [B, S].
        Baseline only."""
        s = self.scores(params, x, beta)  # [B, P]
        g = gumbel((num_samples,) + tuple(s.shape), generator, s.device)
        return torch.argmax(s[None] + g, dim=-1).T


def make_linear_policy(dim_context: int, item_dim: int) -> SoftmaxPolicy:
    """The paper's linear policy h_theta(x) = theta^T x. ``dim_context``
    is the reference's argument and sizes nothing here: the tower's
    parameters come from `linear_tower_init`."""
    del dim_context
    return SoftmaxPolicy(tower=linear_tower_apply, item_dim=item_dim)


def make_mlp_policy(item_dim: int) -> SoftmaxPolicy:
    """A policy over an MLP tower (`mlp_tower_init` / `mlp_tower_apply`)."""
    return SoftmaxPolicy(tower=mlp_tower_apply, item_dim=item_dim)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u), u ~ U(0, 1) from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp(min=tiny))  # Exp(1)
    return -torch.log(e.clamp(min=tiny))

