"""Serving routes: how one padded micro-batch of payloads runs a model.

A route is the engine's model adapter:

    device               where `run` launches its work (the engine
                         synchronises it after `run`)
    pad_payload          the dead-row payload short batches pad with
    prepare(payloads)    host list (len == max_batch) -> device tensors
    run(batch)           the forward; returns device tensors without
                         synchronising
    finalize(out, n)     device results -> the first n responses

Routes that retrieve through a `QueryPlanner` (the MIPS routes) also
expose the degradation-ladder hooks the engine's health monitor drives:
probe / overflow / heal / degrade / degraded.

`RecsysMIPSRoute` serves SASRec and DIEN retrieval: the user tower, then
the plan's `execute_query` over the item table, through the `ivf_topk`
kernel. `LMGenerateRoute` serves LM generation (Gemma-2): a batched
prefill, then greedy decoding in which every next token is a query of
the same plan path over the unembed rows. `DenseCandidateRoute` serves
DIN and Wide&Deep, which have no target-independent user vector (DIN
re-attends per candidate): each request scores a fixed candidate pool
densely (the Yahoo! front-page setting), batched across the requests of
a micro-batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.device import resolve_device
from repro_torch.serve.planner import QueryPlanner

__all__ = ["DenseCandidateRoute", "LMGenerateRoute", "RecsysMIPSRoute"]


class RecsysMIPSRoute:
    """sasrec / dien retrieval: hist [T] -> top-k (ids, scores).

    ``params`` is the model's parameter tree (`repro_torch.models.recsys`);
    it is moved to ``device`` (default "cuda"; see `repro_torch.device`).
    The tower is SASRec's user vector or DIEN's stage-1 GRU state
    projected into item space (`dien_user_vector`). ``probe_hists``
    [n, T] arms the ladder's recall probe."""

    def __init__(
        self, cfg, params, *, k: int = 10, num_clusters: int | None = None,
        n_probe: int | None = None, probe_hists=None, probe_k: int = 32,
        rebuild_iters: int = 4, seed: int = 0, device=None,
    ):
        from repro_torch.models import recsys

        towers = {"sasrec": recsys.sasrec_user_vector, "dien": recsys.dien_user_vector}
        if cfg.kind not in towers:
            raise ValueError(
                f"{cfg.kind} has no target-independent user vector; serve it "
                "through DenseCandidateRoute"
            )
        user_vector = towers[cfg.kind]
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pad_payload = np.full((cfg.seq_len,), -1, np.int32)
        params = _tree_to(params, self.device)
        self.planner = QueryPlanner(
            SoftmaxPolicy(
                tower=lambda p, hist: user_vector(cfg, p, hist),
                item_dim=cfg.embed_dim,
            ),
            params, params["items"], top_k=k, num_clusters=num_clusters, n_probe=n_probe,
            probe_k=probe_k, rebuild_iters=rebuild_iters, seed=seed,
            probe_x=None if probe_hists is None else np.asarray(probe_hists, np.int32),
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

    def probe(self):
        return self.planner.probe()

    def overflow(self) -> int:
        return self.planner.overflow()

    def heal(self, action: str) -> None:
        self.planner.heal(action)

    def degrade(self) -> None:
        self.planner.degrade()


def _identity_tower(params, h):  # noqa: ARG001 — the tower signature
    return h


class LMGenerateRoute:
    """Batched prefill + greedy decode: prompt [prompt_len] -> gen_len
    generated token ids.

    The next-token head is the query-only plan path: the last hidden
    state (after the final norm) goes through an identity tower to
    `execute_query` over the unembed rows, through the `ivf_topk` kernel;
    the token is the slate's best-scoring id (slots need not be sorted;
    a dead -1 slot is clamped to 0). The final soft-cap is monotonic, so
    this is the logits' argmax over the retrieved slate. Tokens stay on
    the device until `finalize`. ``params`` is the `repro_torch.models.lm`
    parameter tree; it is moved to ``device`` (default "cuda"). Prefill
    attention runs the flash-attention kernel when
    ``cfg.use_flash_kernel`` is set, else the chunked plain-torch
    attention. The decode step after the last token is not run: the
    reference runs it and discards its result."""

    def __init__(
        self, cfg, params, *, prompt_len: int, gen_len: int, max_batch: int,
        top_k: int = 4, num_clusters: int | None = None, n_probe: int | None = None,
        probe_hidden=None, probe_k: int = 32, seed: int = 0, device=None,
    ):
        from repro_torch.models import lm

        self.device = resolve_device(device)
        self.cfg = cfg
        self.prompt_len, self.gen_len, self.max_batch = prompt_len, gen_len, max_batch
        self._lm = lm
        self.pad_payload = np.zeros((prompt_len,), np.int32)
        self.params = params = _tree_to(params, self.device)
        unembed = params.get("unembed", params["embed"])
        self.planner = QueryPlanner(
            SoftmaxPolicy(tower=_identity_tower, item_dim=cfg.d_model),
            params, unembed, top_k=top_k, num_clusters=num_clusters,
            n_probe=n_probe, probe_x=probe_hidden, probe_k=probe_k, seed=seed,
            device=self.device,
        )

    def prepare(self, payloads: list) -> torch.Tensor:
        return torch.from_numpy(np.stack(payloads)).to(self.device)

    def prefill(self, tokens: torch.Tensor):
        """[B, prompt_len] -> (hidden [B, d], the filled KV cache)."""
        cache = self._lm.init_cache(
            self.cfg, tokens.shape[0], self.prompt_len + self.gen_len, device=self.device
        )
        return self._lm.prefill(self.cfg, self.params, tokens, cache, return_hidden=True)

    def next_token(self, hidden: torch.Tensor) -> torch.Tensor:
        """The greedy head: hidden [B, d] -> token ids [B] (int32)."""
        slate = self.planner.query(hidden)
        best = torch.argmax(slate.scores, dim=-1, keepdim=True)
        return torch.gather(slate.indices, 1, best)[:, 0].clamp(min=0)

    def generate(self, hidden: torch.Tensor, cache) -> torch.Tensor:
        """gen_len greedy tokens from the prefill's (hidden, cache):
        [B, gen_len] int32, on the device."""
        toks = []
        for t in range(self.gen_len):
            tok = self.next_token(hidden)
            toks.append(tok)
            if t + 1 < self.gen_len:
                hidden, cache = self._lm.decode_step(
                    self.cfg, self.params, tok, cache, return_hidden=True
                )
        return torch.stack(toks, dim=1)

    def run(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, prompt_len] -> [B, gen_len] generated ids, launched without
        waiting for the device."""
        return self.generate(*self.prefill(tokens))

    def warmup(self, max_batch: int) -> None:
        """Run the whole path once, and the planner's fallback too."""
        hidden, cache = self.prefill(self.prepare([self.pad_payload] * max_batch))
        self.planner.warmup(hidden)
        self.generate(hidden, cache)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finalize(self, out, n: int) -> list:
        return [row.tolist() for row in out[:n].cpu().numpy()]

    @property
    def degraded(self) -> bool:
        return self.planner.degraded

    def probe(self):
        return self.planner.probe()

    def overflow(self) -> int:
        return self.planner.overflow()

    def heal(self, action: str) -> None:
        self.planner.heal(action)

    def degrade(self) -> None:
        self.planner.degrade()


class DenseCandidateRoute:
    """din / wide_deep: score a fixed candidate pool per request,
    densely, and return its top-k (ids, scores). A payload is a history
    [T] (din) or (sparse [F], dense [n_dense]) (wide_deep).

    The reference maps `retrieval_topk` over the micro-batch one request
    at a time (`jax.vmap`); here `retrieval_topk` takes the whole batch at
    once and gives each row the reference's answer. ``params`` is moved to
    ``device`` (default "cuda")."""

    def __init__(self, cfg, params, *, candidates, k: int = 10, device=None):
        from repro_torch.models import recsys

        if cfg.kind not in ("din", "wide_deep"):
            raise ValueError(
                f"{cfg.kind} serves through RecsysMIPSRoute, not DenseCandidateRoute"
            )
        self.device = resolve_device(device)
        self.cfg, self.k = cfg, k
        self._recsys = recsys
        self.params = _tree_to(params, self.device)
        self.candidates = torch.from_numpy(np.asarray(candidates, np.int32)).to(self.device)
        if cfg.kind == "wide_deep":
            self.pad_payload = (
                np.zeros((cfg.n_sparse,), np.int32),
                np.zeros((cfg.n_dense,), np.float32),
            )
        else:
            self.pad_payload = np.full((cfg.seq_len,), -1, np.int32)

    def prepare(self, payloads: list) -> dict:
        if self.cfg.kind == "wide_deep":
            return {
                "sparse": torch.from_numpy(np.stack([p[0] for p in payloads])).to(self.device),
                "dense": torch.from_numpy(np.stack([p[1] for p in payloads])).to(self.device),
            }
        return {"hist": torch.from_numpy(np.stack(payloads)).to(self.device)}

    def run(self, batch: dict):
        """(scores [B, K], ids [B, K]), launched without waiting."""
        return self._recsys.retrieval_topk(
            self.cfg, self.params, {**batch, "candidates": self.candidates}, k=self.k
        )

    def warmup(self, max_batch: int) -> None:
        self.run(self.prepare([self.pad_payload] * max_batch))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finalize(self, out, n: int) -> list:
        vals, ids = out[0][:n].cpu().numpy(), out[1][:n].cpu().numpy()
        return [(ids[i], vals[i]) for i in range(n)]


def _tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
