"""Serving routes: how one padded micro-batch of payloads runs a model.

A route is the engine's model adapter:

    device               where `run` launches its work (the engine
                         synchronises it after `run`)
    pad_payload          the dead-row payload short batches pad with
    prepare(payloads)    host list (len == max_batch) -> device tensors
    run(batch)           the forward; returns device tensors without
                         synchronising
    finalize(out, n)     device results -> the first n responses

`RecsysMIPSRoute` serves SASRec retrieval: the user tower, then the
plan's `execute_query` over the item table, through the `ivf_topk`
kernel. DIEN and the LM and dense-candidate routes come with the models
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.device import resolve_device
from repro_torch.serve.planner import QueryPlanner

__all__ = ["RecsysMIPSRoute"]


class RecsysMIPSRoute:
    """sasrec retrieval: hist [T] -> top-k (ids, scores).

    ``params`` is the SASRec parameter tree (`repro_torch.models.recsys`);
    it is moved to ``device`` (default "cuda"; see `repro_torch.device`)."""

    def __init__(
        self, cfg, params, *, k: int = 10, n_probe: int | None = None,
        seed: int = 0, device=None,
    ):
        from repro_torch.models import recsys

        if cfg.kind != "sasrec":
            raise NotImplementedError(
                f"{cfg.kind} is not ported yet: the serving slice ports the "
                "sasrec route; the others come with the models slice"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pad_payload = np.full((cfg.seq_len,), -1, np.int32)
        params = _tree_to(params, self.device)
        self.planner = QueryPlanner(
            SoftmaxPolicy(
                tower=lambda p, hist: recsys.sasrec_user_vector(cfg, p, hist),
                item_dim=cfg.embed_dim,
            ),
            params, params["items"], top_k=k, n_probe=n_probe, seed=seed,
            device=self.device,
        )

    def prepare(self, payloads: list) -> torch.Tensor:
        return torch.from_numpy(np.stack(payloads)).to(self.device)

    def run(self, batch: torch.Tensor):
        return self.planner.query(batch)

    def warmup(self, max_batch: int) -> None:
        self.planner.warmup(self.prepare([self.pad_payload] * max_batch))

    def finalize(self, out, n: int) -> list:
        ids = out.indices[:n].cpu().numpy()
        scores = out.scores[:n].cpu().numpy()
        return [(ids[i], scores[i]) for i in range(n)]

    @property
    def degraded(self) -> bool:
        return self.planner.degraded

    def degrade(self) -> None:
        self.planner.degrade()


def _tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
