"""Public wrapper of the in-kernel mixture sampler.

`fused_mixture_sample` takes the port's seed (an int, or a CPU
`torch.Generator` it draws one int32 from; the reference folds a JAX key
instead, `repro/kernels/fused_sampler/ops.py:key_to_seed`) and returns
tile-aligned (actions, log_q, topk_slot), each [B, Sp] with
Sp = ceil(S / TS) * TS and the padded tail pre-masked (action -1,
log_q LOG_Q_PAD): the layout the covgrad ops consume without padding.

Dispatch is by the device of the tensors: on the CPU it is the plain
PyTorch version (`ref.py`); on CUDA it is the hand-written kernel, or an
error. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_sampler import kernel as _kernel
from repro_torch.kernels.fused_sampler import ref as _ref

__all__ = ["INT32_MAX", "fused_mixture_sample", "seed_from"]

INT32_MAX = 2**31 - 1


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def seed_from(seed: int | torch.Generator) -> int:
    """The kernel's int32 seed: an int as it is, or one draw in
    [0, 2^31 - 1) from a CPU generator (no device read)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, INT32_MAX, (), generator=seed))
    return int(seed)


def fused_mixture_sample(
    seed: int | torch.Generator,
    topk_indices: torch.Tensor,  # [B, K]
    topk_scores: torch.Tensor,  # [B, K]
    *,
    num_samples: int,
    epsilon: float | torch.Tensor,  # 0 <= eps < 1, a float or a 0-d tensor
    num_items: int,
    sample_tile: int,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw S eps-mixture actions per context; returns (actions [B, Sp],
    log_q [B, Sp], topk_slot [B, Sp])."""
    ids = topk_indices.to(torch.int32).contiguous()
    scores = topk_scores.to(torch.float32).contiguous()
    if isinstance(epsilon, torch.Tensor):
        eps = epsilon.to(device=ids.device, dtype=torch.float32).reshape(())
    else:
        eps = torch.full((), float(epsilon), dtype=torch.float32, device=ids.device)
    fn = _kernel.fused_sampler_cuda if _on_cuda(ids) else _ref.fused_sampler_ref
    return fn(
        seed_from(seed), eps, ids, scores, num_samples=num_samples,
        num_items=num_items, sample_tile=sample_tile, row_offset=row_offset,
    )
