"""Softmax policies over large discrete action spaces.

pi_theta(a|x) = softmax_a(h_theta(x)^T beta_a), with the fixed item
table beta passed explicitly. The serving slice needs only the user
embedding h_theta; the scoring and sampling helpers come with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Params = Any
Tower = Callable[[Params, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SoftmaxPolicy:
    """`tower` maps (params, x [B, Dx]) -> h [B, L]; `item_dim` == L."""

    tower: Tower
    item_dim: int

    def user_embedding(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.tower(params, x)
