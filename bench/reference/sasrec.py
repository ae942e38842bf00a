"""The plain reference of SASRec bulk retrieval (arXiv:1808.09781):
the user tower, then an IVF-Flat index over the item table probed at
n_probe lists, then the top-K of the probed items.

- `user_vectors` is a frozen copy of `repro_torch.models.recsys
  .sasrec_user_vector` (with `models.layers.rms_norm` and `mlp_apply`):
  ids at the front of a history, -1 after; the query is the hidden state
  at position count(ids) - 1.
- `build_index` is a frozen copy of `repro_torch.mips.ivf.build_ivf`
  with its default capacity (k-means++ seeds from a
  `torch.Generator` on the items' device seeded with the index seed,
  then 12 Lloyd iterations). Lloyd's iterations amplify the last bit of
  a centroid sum into other lists, so both builds run under torch's
  deterministic algorithms (`deterministic`): the same ops on the same
  device then give the same lists.
- `answers` scores each query's probed lists and keeps the top-K, equal
  scores in list order.

Every product goes through `precision.cast`, so the same code is the
control in TF32.
"""
from __future__ import annotations

import contextlib
import math
import warnings

import torch

from bench.reference.precision import cast

__all__ = ["answers", "build_index", "deterministic", "user_vectors"]

ASSIGN_SCORES = 1 << 28  # rows x centroids of one assignment block (`mips.ivf`)
NEG_INF = -3.0e38


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block (index sums by
    sorted segments instead of atomics); their warnings about other ops
    are silenced."""
    prev, prev_warn = (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


# -- the tower ----------------------------------------------------------------

def _rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def user_vectors(params: dict, hist: torch.Tensor, num_heads: int, precision: str) -> torch.Tensor:
    """[B, T] histories -> [B, D] queries."""
    c = lambda t: cast(t, precision)  # noqa: E731
    mask = hist >= 0
    emb = params["items"][hist.clamp(min=0).long()] * mask[..., None]
    b, t, d = emb.shape
    h = emb + params["pos"][None, :t]
    dh = d // num_heads
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=hist.device))
    m = causal[None, None] & mask[:, None, None, :]
    for blk in params["blocks"]:
        y = c(_rms_norm(h, blk["ln1"]))
        q = (y @ c(blk["wq"])).reshape(b, t, num_heads, dh)
        k = (y @ c(blk["wk"])).reshape(b, t, num_heads, dh)
        v = (y @ c(blk["wv"])).reshape(b, t, num_heads, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", c(q), c(k)) / float(dh) ** 0.5
        att = torch.softmax(torch.where(m, s, -1e30), dim=-1)
        h = h + torch.einsum("bhqk,bkhd->bqhd", c(att), c(v)).reshape(b, t, d)
        z = _rms_norm(h, blk["ln2"])
        ffn = blk["ffn"]
        for i, layer in enumerate(ffn):
            z = c(z) @ c(layer["w"]) + layer["b"]
            if i + 1 < len(ffn):
                z = torch.relu(z)
        h = h + z
    last = torch.clamp(mask.sum(dim=1) - 1, min=0)
    return h[torch.arange(b, device=h.device), last]


# -- the index ----------------------------------------------------------------

def _assign(points, centroids, precision: str) -> torch.Tensor:
    c_norm = 0.5 * torch.sum(centroids**2, dim=-1)
    rows = max(1, ASSIGN_SCORES // max(1, centroids.shape[0]))
    ct = cast(centroids, precision).T
    return torch.cat([torch.argmax(cast(chunk, precision) @ ct - c_norm[None, :], dim=-1)
                      for chunk in points.split(rows)]).to(torch.int32)


def build_index(items: torch.Tensor, num_clusters: int, seed: int, precision: str,
                iters: int = 12) -> tuple[torch.Tensor, torch.Tensor]:
    """(centroids [C, L], lists [C, cap] int32, -1 padded) of the items,
    cap the largest list rounded up to a power of two, items in each list
    in id order."""
    p, l = items.shape
    c = num_clusters
    gen = torch.Generator(device=items.device).manual_seed(seed)
    first = items[torch.randint(0, p, (1,), generator=gen, device=items.device)]
    d2 = torch.sum((items - first) ** 2, dim=-1)
    cents = torch.empty((c, l), dtype=items.dtype, device=items.device)
    cents[:1] = first
    for i in range(1, c):
        nxt = items[torch.multinomial(d2 + 1e-20, 1, generator=gen)]
        d2 = torch.minimum(d2, torch.sum((items - nxt) ** 2, dim=-1))
        cents[i:i + 1] = nxt
    ones = torch.ones((p,), dtype=items.dtype, device=items.device)
    for _ in range(iters):
        assign = _assign(items, cents, precision).long()
        sums = torch.zeros_like(cents).index_add_(0, assign, items)
        counts = torch.zeros((c,), dtype=items.dtype, device=items.device).index_add_(
            0, assign, ones)
        new_c = sums / torch.clamp(counts[:, None], min=1.0)
        cents = torch.where(counts[:, None] > 0, new_c, cents)
    assign = _assign(items, cents, precision).long()
    sizes = torch.bincount(assign, minlength=c)
    cap = int(2 ** math.ceil(math.log2(max(int(sizes.max()), 1))))
    order = torch.argsort(assign, stable=True)
    onset = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(p, device=items.device) - onset[assign[order]]
    lists = torch.full((c, cap), -1, dtype=torch.int32, device=items.device)
    lists[assign[order], rank] = order.to(torch.int32)
    return cents, lists


def answers(u: torch.Tensor, centroids: torch.Tensor, lists: torch.Tensor,
            items: torch.Tensor, k: int, n_probe: int, precision: str,
            block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, K] descending, ids [B, K] int32, -1 where a query's
    probed lists hold fewer than K items)."""
    probe = torch.topk(cast(u, precision) @ cast(centroids, precision).T, n_probe, dim=1).indices
    vals, ids = [], []
    for r0 in range(0, u.shape[0], block):
        cand = lists[probe[r0:r0 + block]].reshape(probe[r0:r0 + block].shape[0], -1)
        emb = cast(items[cand.clamp(min=0).long()], precision)
        s = torch.einsum("bl,bnl->bn", cast(u[r0:r0 + block], precision), emb)
        s = torch.where(cand >= 0, s, NEG_INF)
        v, pos = torch.sort(s, dim=1, descending=True, stable=True)
        ids.append(torch.where(v[:, :k] > NEG_INF, torch.gather(cand, 1, pos[:, :k]), -1))
        vals.append(v[:, :k])
    return torch.cat(vals), torch.cat(ids).to(torch.int32)
