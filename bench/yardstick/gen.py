"""The benchmark's input generators: every input of a run is made here,
on the device, from the run's seed, in a few large calls.

Frozen copies, so that a change to the program cannot move the
yardstick:

- `clustered_catalog` follows `repro_torch.data.synthetic
  .clustered_catalog` (tight Gaussian clusters of equal centre norm;
  each query a blend of two centres), drawn with a `torch.Generator` on
  the card instead of numpy.
- `session_positives` follows `chip_smoke.py:training_data` (8 positives
  a context, drawn from its exact top-64 under theta0).
- `zipf_histories` follows `repro_torch.data.synthetic._zipf_probs` for
  the skew (p(rank r) ~ r^-a) and `chip_smoke.py:recsys_payloads` for the
  layout (ids, -1 padded), with ragged lengths.
- `sasrec_params` lays SASRec's weights out as `repro_torch.models.recsys
  .sasrec_init` does, with its scales, drawn in three calls.
- `batch_rows` is `repro_torch.data.loader.BatchLoader`'s order rule
  (`_perm`, `next_batch`), which the reference follows.

`sub_seed` derives the seeds of separate streams from the run's seed,
which may be any whole number up to a little over 2^31.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "batch_rows", "clustered_catalog", "device_generator", "sasrec_params",
    "session_positives", "sub_seed", "zipf_histories",
]

_M63 = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A seed for stream ``stream`` of run ``seed``: a splitmix64 step, so
    nearby run seeds give unrelated streams."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 29
    return x & _M63


def device_generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def clustered_catalog(num_items: int, embed_dim: int, num_clusters: int,
                      num_queries: int, *, std: float, query_blend: float,
                      gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(items [P, L], queries [N, L]) float32 on ``gen``'s device: items
    around ``num_clusters`` centres of norm sqrt(L), each query a
    ``query_blend`` mix of two random centres plus the same noise."""
    dev = gen.device
    centers = torch.randn((num_clusters, embed_dim), generator=gen, device=dev)
    centers *= math.sqrt(embed_dim) / torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    assign = torch.randint(0, num_clusters, (num_items,), generator=gen, device=dev)
    items = torch.randn((num_items, embed_dim), generator=gen, device=dev).mul_(std)
    items += centers[assign]
    pair = torch.randint(0, num_clusters, (2, num_queries), generator=gen, device=dev)
    queries = torch.randn((num_queries, embed_dim), generator=gen, device=dev).mul_(std)
    queries += (1.0 - query_blend) * centers[pair[0]] + query_blend * centers[pair[1]]
    return items, queries


def session_positives(h0: torch.Tensor, items: torch.Tensor, top: int, keep: int,
                      gen: torch.Generator, block: int = 2048) -> torch.Tensor:
    """[N, keep] int32: ``keep`` distinct ids drawn uniformly from each row's
    exact top-``top`` of h0 @ items.T (fp32 products, in row blocks)."""
    ids = torch.cat([torch.topk(h0[i:i + block] @ items.T, top, dim=1).indices
                     for i in range(0, h0.shape[0], block)])
    pick = torch.rand(ids.shape, generator=gen, device=ids.device).argsort(dim=1)[:, :keep]
    return torch.gather(ids, 1, pick).to(torch.int32)


def zipf_histories(num_users: int, seq_len: int, num_items: int, zipf_a: float,
                   gen: torch.Generator) -> torch.Tensor:
    """[U, T] int32 histories: a length uniform in 1..T, ids at the front,
    -1 after; ids Zipf(a)-skewed over the catalog through a seeded
    permutation, so the popular ids are spread over the table."""
    dev = gen.device
    ranks = torch.arange(1, num_items + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks.pow(-zipf_a), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((num_users, seq_len), generator=gen, device=dev, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp_(max=num_items - 1)
    perm = torch.randperm(num_items, generator=gen, device=dev)
    ids = perm[rank].to(torch.int32)
    length = torch.randint(1, seq_len + 1, (num_users, 1), generator=gen, device=dev)
    pos = torch.arange(seq_len, device=dev)[None, :]
    return torch.where(pos < length, ids, -1)


def sasrec_params(item_vocab: int, embed_dim: int, seq_len: int, num_blocks: int,
                  gen: torch.Generator) -> dict:
    """SASRec's parameter tree: the item table N(0, 1/D), positions
    N(0, 0.02^2), and per block q, k, v and a two-layer feed-forward
    N(0, 1/D) with zero biases and zero norm scales."""
    dev, d = gen.device, embed_dim
    items = torch.randn((item_vocab, d), generator=gen, device=dev).div_(math.sqrt(d))
    pos = torch.randn((seq_len, d), generator=gen, device=dev).mul_(0.02)
    w = torch.randn((num_blocks, 5, d, d), generator=gen, device=dev).div_(math.sqrt(d))
    zeros = lambda: torch.zeros((d,), device=dev)  # noqa: E731
    blocks = [{"wq": w[i, 0], "wk": w[i, 1], "wv": w[i, 2],
               "ffn": [{"w": w[i, 3], "b": zeros()}, {"w": w[i, 4], "b": zeros()}],
               "ln1": zeros(), "ln2": zeros()} for i in range(num_blocks)]
    return {"items": items, "pos": pos, "blocks": blocks}


def batch_rows(n: int, batch: int, seed: int, step: int) -> np.ndarray:
    """The rows of the loader's batch number ``step`` (0-based) over ``n``
    rows: epoch ``step // (n // batch)``'s permutation from
    ``default_rng((seed, epoch))``, cut into batches, the remainder dropped."""
    per_epoch = n // batch
    epoch, pos = divmod(step, per_epoch)
    perm = np.random.default_rng((seed, epoch)).permutation(n)
    return perm[pos * batch:(pos + 1) * batch]
