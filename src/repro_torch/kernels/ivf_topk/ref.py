"""The plain PyTorch version of the IVF top-K kernel.

Same function as `ivf_probe_topk_cuda`: gather the probed lists and
their embeddings, score them with one einsum, mask the padded slots and
take the top-K. Unlike the kernel it materialises the
[B, n_probe*capp, L] candidate tensor. The CPU path and the tests use
it; on the card it is only the yardstick the kernel is held to. It
counts its calls in ``ivf_probe_topk_ref.calls``.
"""
from __future__ import annotations

import torch

from repro_torch.constants import NEG_INF

__all__ = ["ivf_probe_topk_ref"]


def ivf_probe_topk_ref(
    queries: torch.Tensor,  # [B, L] float32
    probe: torch.Tensor,  # [B, n_probe] cluster ids
    lists: torch.Tensor,  # [C, capp] int32 item ids, -1 padded
    list_embs: torch.Tensor,  # [C, capp, L] float32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] float32 descending, ids [B, K] int32); rows short
    of K live candidates back-fill (NEG_INF, -1)."""
    ivf_probe_topk_ref.calls += 1
    b = queries.shape[0]
    probe = probe.long()
    cand_ids = lists[probe].reshape(b, -1)  # [B, n_probe*capp]
    cand_embs = list_embs[probe].reshape(b, cand_ids.shape[1], -1)
    scores = torch.einsum("bl,bnl->bn", queries, cand_embs)
    scores = torch.where(cand_ids >= 0, scores, NEG_INF)
    # K dead slots in front, as the kernel's running top-K starts: the
    # back-fill for rows short of K, and a tie with them loses
    dead_s = torch.full((b, k), NEG_INF, dtype=scores.dtype, device=scores.device)
    dead_i = torch.full((b, k), -1, dtype=cand_ids.dtype, device=cand_ids.device)
    scores = torch.cat([dead_s, scores], dim=1)
    cand_ids = torch.cat([dead_i, torch.where(cand_ids >= 0, cand_ids, -1)], dim=1)
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, torch.gather(cand_ids, 1, pos).to(torch.int32)


ivf_probe_topk_ref.calls = 0
