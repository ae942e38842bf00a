"""Synthetic session-completion data, the paper's experimental protocol
without the Twitch / GoodReads dumps. A numpy-only copy of the
reference's `repro/data/synthetic.py` (the port imports nothing of the
reference): the same seed gives the same arrays, bit for bit.

The generator reproduces the *statistical shape* the paper relies on:
  * a large catalog with power-law (Zipf) item popularity,
  * users with latent taste vectors; sessions are items drawn from a
    mixture of user taste and global popularity,
  * each session split in half: observed X (context) / held-out Y
    (completion targets) — exactly the paper's protocol,
  * item embeddings from a truncated SVD of the train interaction
    matrix, user contexts as mean item embeddings (Koch et al. 2021).

Presets `twitch_like` (P=750K) and `goodreads_like` (P=1.23M) match the
paper's Table 1 scales; tests/benches use scaled-down versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SessionDataset:
    """Padded session-completion dataset (numpy, host-side)."""

    contexts: np.ndarray  # [N, L] float32 — mean item embeddings of X
    positives: np.ndarray  # [N, Y_max] int32 — completion targets, -1 pad
    item_embeddings: np.ndarray  # [P, L] float32 — the fixed beta (SVD)
    num_items: int

    def split(self, frac: float = 0.9, seed: int = 0):
        rng = np.random.default_rng(seed)
        n = self.contexts.shape[0]
        perm = rng.permutation(n)
        cut = int(n * frac)
        tr, te = perm[:cut], perm[cut:]
        mk = lambda idx: SessionDataset(
            self.contexts[idx], self.positives[idx], self.item_embeddings, self.num_items
        )
        return mk(tr), mk(te)


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    num_items: int = 20_000
    num_users: int = 5_000
    embed_dim: int = 32  # L
    latent_dim: int = 16  # ground-truth taste dim (!= L on purpose)
    session_len: int = 20  # items per session (split X/Y in half)
    zipf_a: float = 1.1
    taste_weight: float = 0.8  # vs popularity
    seed: int = 0


def _zipf_probs(p: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, p + 1) ** a
    return w / w.sum()


def generate_sessions(cfg: SyntheticConfig) -> SessionDataset:
    rng = np.random.default_rng(cfg.seed)
    pop = _zipf_probs(cfg.num_items, cfg.zipf_a)

    # latent structure: items + users live in a shared taste space
    item_lat = rng.normal(size=(cfg.num_items, cfg.latent_dim)).astype(np.float32)
    user_lat = rng.normal(size=(cfg.num_users, cfg.latent_dim)).astype(np.float32)

    half = cfg.session_len // 2
    interactions = np.zeros((cfg.num_users, cfg.session_len), np.int64)
    for u in range(cfg.num_users):
        # user-conditional item distribution: softmax(taste) mixed with pop
        logits = item_lat @ user_lat[u] / np.sqrt(cfg.latent_dim)
        logits -= logits.max()
        taste = np.exp(logits)
        taste /= taste.sum()
        probs = cfg.taste_weight * taste + (1 - cfg.taste_weight) * pop
        interactions[u] = rng.choice(
            cfg.num_items, size=cfg.session_len, replace=False, p=probs
        )

    x_items = interactions[:, :half]  # observed
    y_items = interactions[:, half:]  # completion targets

    # item embeddings: truncated SVD of the (binary) train interaction matrix,
    # computed via the item-item co-occurrence eigendecomposition so we never
    # materialise the dense [N_users, P] matrix.
    beta = _svd_item_embeddings(x_items, cfg.num_items, cfg.embed_dim, rng)

    contexts = beta[x_items].mean(axis=1).astype(np.float32)  # [N, L]
    return SessionDataset(
        contexts=contexts,
        positives=y_items.astype(np.int32),
        item_embeddings=beta,
        num_items=cfg.num_items,
    )


def _svd_item_embeddings(
    x_items: np.ndarray, num_items: int, dim: int, rng: np.random.Generator
) -> np.ndarray:
    """Rank-`dim` SVD right factors of the user-item matrix M (binary).
    M = U S V^T  =>  item embeddings beta = V S (dim columns). We get V from
    the eigendecomposition of the item-item Gram M^T M accumulated sparsely,
    with a randomized projection when the catalog is large."""
    n_users, sess = x_items.shape
    # sparse accumulation of co-occurrence counts through a projection:
    # G = M^T M has nnz ~ n_users * sess^2; for big P use randomized range.
    proj_dim = min(num_items, max(4 * dim, 64))
    omega = rng.normal(size=(num_items, proj_dim)).astype(np.float32)
    # Y = M^T (M Omega): accumulate per user without densifying M
    m_omega = np.zeros((n_users, proj_dim), np.float32)
    for s in range(sess):
        m_omega += omega[x_items[:, s]]
    y = np.zeros((num_items, proj_dim), np.float32)
    for s in range(sess):
        np.add.at(y, x_items[:, s], m_omega)
    q, _ = np.linalg.qr(y)  # [P, proj_dim] orthonormal range of G
    # small eigenproblem in the range: B = Q^T G Q via the same trick
    m_q = np.zeros((n_users, proj_dim), np.float32)
    for s in range(sess):
        m_q += q[x_items[:, s]]
    gq = np.zeros((num_items, proj_dim), np.float32)
    for s in range(sess):
        np.add.at(gq, x_items[:, s], m_q)
    b = q.T @ gq
    evals, evecs = np.linalg.eigh((b + b.T) / 2)
    order = np.argsort(evals)[::-1][:dim]
    vecs = q @ evecs[:, order]  # [P, dim] ~ top right-singular vectors
    svals = np.sqrt(np.maximum(evals[order], 1e-12))
    beta = (vecs * svals[None, :]).astype(np.float32)
    # scale so scores have O(1) spread (softmax-friendly, like unit-norm SVD)
    beta /= max(np.linalg.norm(beta, axis=1).mean(), 1e-6)
    return beta


def twitch_like(scale: float = 1.0, embed_dim: int = 100, seed: int = 0) -> SyntheticConfig:
    return SyntheticConfig(
        num_items=int(750_000 * scale),
        num_users=int(500_000 * scale),
        embed_dim=embed_dim,
        seed=seed,
    )


def goodreads_like(scale: float = 1.0, embed_dim: int = 100, seed: int = 0) -> SyntheticConfig:
    return SyntheticConfig(
        num_items=int(1_230_000 * scale),
        num_users=int(300_000 * scale),
        embed_dim=embed_dim,
        seed=seed,
    )


def clustered_catalog(
    num_items: int,
    embed_dim: int,
    num_clusters: int,
    num_queries: int,
    *,
    std: float = 0.05,
    query_blend: float = 0.5,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(items [P, L], queries [B, L]): a catalog drawn from tight
    Gaussian clusters — the structured-embedding regime IVF-style
    retrievers exploit (real recommendation catalogs cluster; isotropic
    Gaussians are the adversarial case). One generator shared by the
    IVF recall tests and the retrieval benchmark gate, so their notion
    of "clustered" cannot drift.

    Each query is a ``query_blend`` mixture of TWO random cluster
    centers, so its top-K straddles both clusters and recall genuinely
    *varies* with n_probe (~0.5 at n_probe=1, ~1.0 from 2) — a
    single-center query would sit entirely inside one cluster and
    saturate every recall gate at n_probe=1, leaving multi-probe
    regressions (merge bugs, probe-ranking bugs) undetectable. Set
    query_blend=0 for the easy single-cluster regime."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_clusters, embed_dim))
    # equal center norms: otherwise the larger-norm cluster of a blended
    # pair wins the whole top-K by ~|c_a|^2 - |c_b|^2 (chi^2 spread) and
    # the straddle — the thing that makes recall vary with n_probe —
    # never happens
    centers *= np.sqrt(embed_dim) / np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, num_clusters, size=num_items)
    items = centers[assign] + std * rng.standard_normal((num_items, embed_dim))
    qa = rng.integers(0, num_clusters, size=num_queries)
    qb = rng.integers(0, num_clusters, size=num_queries)
    queries = (
        (1.0 - query_blend) * centers[qa]
        + query_blend * centers[qb]
        + std * rng.standard_normal((num_queries, embed_dim))
    )
    return items.astype(np.float32), queries.astype(np.float32)
