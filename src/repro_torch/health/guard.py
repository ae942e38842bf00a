"""The training guard's gradient norm. The verdict bitmask, skip-step
and rollback come with the health slice; the trainer reports this norm
in ``aux["grad_norm"]`` already, as the reference's does."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.optimizers import tree_leaves

__all__ = ["grad_global_norm"]


def grad_global_norm(grads: Any) -> torch.Tensor:
    """Global L2 norm over a nested dict of gradients (fp32 accumulate).
    A NaN / Inf in any leaf surfaces as a non-finite norm."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
