"""Recsys models of the port: DIN, DIEN, SASRec and Wide&Deep, for serving.

Parameters are plain trees of tensors with the reference's layout
(`repro/models/recsys.py`), so `repro_torch.convert.recsys_params_from_numpy`
carries the reference's weights across one to one. Each model exposes
`init_params`, `forward` (ranking logits [B]) and the candidate scoring of
`retrieval_topk`; the user towers `sasrec_user_vector` and
`dien_user_vector` feed the MIPS serving route. The reference's two
`lax.scan`s over the history (DIEN's GRU and AUGRU) are Python loops over
T with the same masked update. The reference's candidate scoring takes
one query (B = 1); here it takes a batch of B and gives each row the
reference's answer. Training (`bce_loss`, `make_train_step`) comes with
the recsys training part of the models slice (ROADMAP Queue A item 6).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.embeddings.bag import _M32, hash_bucket
from repro_torch.mips.streaming import topk_streaming
from repro_torch.models.configs_base import RecsysConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, rms_norm

__all__ = [
    "dien_forward",
    "dien_init",
    "dien_user_vector",
    "din_forward",
    "din_init",
    "din_retrieval_scores",
    "forward",
    "init_params",
    "retrieval_topk",
    "sasrec_forward",
    "sasrec_init",
    "sasrec_user_vector",
    "wide_deep_forward",
    "wide_deep_init",
]

# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _item_table(cfg: RecsysConfig, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(
        (cfg.item_vocab, cfg.embed_dim), generator=generator, device=device
    ) / cfg.embed_dim**0.5


def _hist_embed(table: torch.Tensor, hist: torch.Tensor):
    """[B, T] padded ids (-1 = empty) -> ([B, T, D], [B, T] mask)."""
    mask = hist >= 0
    emb = table[hist.clamp(min=0).long()]
    return emb * mask[..., None], mask


# ---------------------------------------------------------------------------
# DIN: Deep Interest Network (target attention)
# ---------------------------------------------------------------------------

def din_init(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    d = cfg.embed_dim
    return {
        "items": _item_table(cfg, generator, device),
        "attn_mlp": mlp_init((4 * d,) + cfg.attn_mlp_dims + (1,), generator, device),
        "mlp": mlp_init((2 * d,) + cfg.mlp_dims + (1,), generator, device),
    }


def _din_attention(params, hist_emb, mask, tgt_emb):
    """hist [..., T, D], mask [..., T], tgt [..., D] -> interest [..., D]."""
    tgt = tgt_emb[..., None, :].expand_as(hist_emb)
    feat = torch.cat([hist_emb, tgt, hist_emb - tgt, hist_emb * tgt], dim=-1)  # [..., T, 4D]
    scores = mlp_apply(params["attn_mlp"], feat, act=torch.sigmoid)[..., 0]
    scores = torch.where(mask, scores, 0.0)  # DIN: no softmax, masked weights
    return torch.einsum("...t,...td->...d", scores, hist_emb)


def din_forward(cfg: RecsysConfig, params, hist, target) -> torch.Tensor:
    hist_emb, mask = _hist_embed(params["items"], hist)
    tgt_emb = params["items"][target.long()]
    interest = _din_attention(params, hist_emb, mask, tgt_emb)
    x = torch.cat([interest, tgt_emb], dim=-1)
    return mlp_apply(params["mlp"], x, act=torch.relu)[..., 0]  # [B]


def din_retrieval_scores(cfg, params, hist, candidates) -> torch.Tensor:
    """hist [B, T]; candidates [C] -> scores [B, C]: target attention
    recomputed per candidate (DIN's retrieval cost). The reference's
    takes hist [1, T] and returns row 0."""
    hist_emb, mask = _hist_embed(params["items"], hist)  # [B, T, D]
    cand_emb = params["items"][candidates.long()]  # [C, D]
    b, t, d = hist_emb.shape
    c = cand_emb.shape[0]
    tgt = cand_emb.expand(b, c, d)
    interest = _din_attention(
        params, hist_emb[:, None].expand(b, c, t, d), mask[:, None].expand(b, c, t), tgt
    )  # [B, C, D]
    x = torch.cat([interest, tgt], dim=-1)
    return mlp_apply(params["mlp"], x, act=torch.relu)[..., 0]


# ---------------------------------------------------------------------------
# DIEN: interest evolution, GRU + attentional AUGRU
# ---------------------------------------------------------------------------

def _gru_init(d_in: int, d_h: int, generator: torch.Generator, device) -> dict:
    return {
        "wz": dense_init(d_in + d_h, d_h, generator, device),
        "wr": dense_init(d_in + d_h, d_h, generator, device),
        "wh": dense_init(d_in + d_h, d_h, generator, device),
        "bz": torch.zeros((d_h,), device=device),
        "br": torch.zeros((d_h,), device=device),
        "bh": torch.zeros((d_h,), device=device),
    }


def _gru_cell(p, h, x, a=None):
    """Standard GRU; if the attention score `a` is given, AUGRU (a scales z)."""
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(hx @ p["wz"] + p["bz"])
    r = torch.sigmoid(hx @ p["wr"] + p["br"])
    hc = torch.tanh(torch.cat([x, r * h], dim=-1) @ p["wh"] + p["bh"])
    if a is not None:
        z = z * a[..., None]
    return (1 - z) * h + z * hc


def dien_init(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    d, g = cfg.embed_dim, cfg.gru_dim
    return {
        "items": _item_table(cfg, generator, device),
        "gru1": _gru_init(d, g, generator, device),
        "augru": _gru_init(g, g, generator, device),
        "attn_w": dense_init(g, d, generator, device),
        "mlp": mlp_init((g + d,) + cfg.mlp_dims + (1,), generator, device),
    }


def _gru_states(cfg, params, hist_emb, mask) -> list[torch.Tensor]:
    """The first GRU over the history: the state after each t ([B, g]
    each), held where the history is padding."""
    h = hist_emb.new_zeros((hist_emb.shape[0], cfg.gru_dim))
    states = []
    for t in range(hist_emb.shape[1]):
        h = torch.where(mask[:, t, None], _gru_cell(params["gru1"], h, hist_emb[:, t]), h)
        states.append(h)
    return states


def _dien_interest(cfg, params, hist, target_emb):
    """The final AUGRU state [B, g]."""
    hist_emb, mask = _hist_embed(params["items"], hist)  # [B, T, D]
    states = torch.stack(_gru_states(cfg, params, hist_emb, mask))  # [T, B, g]
    # attention of each interest state vs the target embedding
    att_logits = torch.einsum("tbg,gd,bd->tb", states, params["attn_w"], target_emb)
    att_logits = torch.where(mask.T, att_logits, -1e30)
    att = torch.softmax(att_logits, dim=0)  # over T
    h = torch.zeros_like(states[0])
    for t in range(states.shape[0]):
        h_new = _gru_cell(params["augru"], h, states[t], att[t])
        h = torch.where(mask[:, t, None], h_new, h)
    return h


def dien_forward(cfg: RecsysConfig, params, hist, target) -> torch.Tensor:
    tgt_emb = params["items"][target.long()]
    interest = _dien_interest(cfg, params, hist, tgt_emb)
    x = torch.cat([interest, tgt_emb], dim=-1)
    return mlp_apply(params["mlp"], x, act=torch.relu)[..., 0]


def dien_user_vector(cfg, params, hist) -> torch.Tensor:
    """The target-independent first-stage state for MIPS retrieval: the
    GRU's final state projected into item space, [B, D]."""
    hist_emb, mask = _hist_embed(params["items"], hist)
    return _gru_states(cfg, params, hist_emb, mask)[-1] @ params["attn_w"]


# ---------------------------------------------------------------------------
# SASRec: self-attentive sequential recommendation
# ---------------------------------------------------------------------------

def sasrec_init(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    """Random SASRec parameters, drawn from ``generator`` on ``device``
    with the reference's scales (its draws differ: another generator)."""
    d = cfg.embed_dim
    params = {
        "items": _item_table(cfg, generator, device),
        "pos": torch.randn((cfg.seq_len, d), generator=generator, device=device) * 0.02,
        "blocks": [],
    }
    for _ in range(cfg.num_blocks):
        params["blocks"].append(
            {
                "wq": dense_init(d, d, generator, device),
                "wk": dense_init(d, d, generator, device),
                "wv": dense_init(d, d, generator, device),
                "ffn": mlp_init((d, d, d), generator, device),
                "ln1": torch.zeros((d,), device=device),
                "ln2": torch.zeros((d,), device=device),
            }
        )
    return params


def sasrec_user_vector(cfg: RecsysConfig, params, hist: torch.Tensor) -> torch.Tensor:
    """hist [B, T] -> the hidden state [B, D] at the "last" position, the
    MIPS query h(x).

    Attention is written out as matmuls and a softmax, as the reference
    writes it; masked logits are -1e30 (not -inf), so a row with no valid
    key attends uniformly, as in the reference. The "last" position is
    max(count(hist >= 0) - 1, 0), not the index of the last valid id:
    with -1 holes in the middle of a history the two differ, and the
    reference takes the former."""
    emb, mask = _hist_embed(params["items"], hist)  # [B, T, D]
    b, t, d = emb.shape
    h = emb + params["pos"][None, :t]
    nh = cfg.num_heads
    dh = d // nh
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=hist.device))
    m = causal[None, None] & mask[:, None, None, :]  # [B, 1, T, T]
    for blk in params["blocks"]:
        y = rms_norm(h, blk["ln1"])
        q = (y @ blk["wq"]).reshape(b, t, nh, dh)
        k = (y @ blk["wk"]).reshape(b, t, nh, dh)
        v = (y @ blk["wv"]).reshape(b, t, nh, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(dh) ** 0.5
        s = torch.where(m, s, -1e30)
        att = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, t, d)
        h = h + o
        h = h + mlp_apply(blk["ffn"], rms_norm(h, blk["ln2"]), act=torch.relu)
    last = torch.clamp(mask.sum(dim=1) - 1, min=0)  # [B]
    return h[torch.arange(b, device=h.device), last]


def sasrec_forward(cfg: RecsysConfig, params, hist, target) -> torch.Tensor:
    u = sasrec_user_vector(cfg, params, hist)
    tgt = params["items"][target.long()]
    return torch.sum(u * tgt, dim=-1)  # [B] dot-product score


# ---------------------------------------------------------------------------
# Wide & Deep
# ---------------------------------------------------------------------------

def wide_deep_init(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    d = cfg.embed_dim
    rows = cfg.field_vocab * 4
    return {
        # one shared hashed table across fields; a per-field salt
        # disambiguates
        "embed": torch.randn((rows, d), generator=generator, device=device) / d**0.5,
        "wide": torch.randn((rows, 1), generator=generator, device=device) * 0.01,
        "dense_wide": dense_init(cfg.n_dense, 1, generator, device),
        "deep": mlp_init(
            (cfg.n_sparse * d + cfg.n_dense,) + cfg.mlp_dims + (1,), generator, device
        ),
    }


def _wd_flat_ids(cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """[B, F] per-field ids -> hashed ids into the shared table, int32:
    field f's ids salted by f * 0x1000193 in uint32 arithmetic (the add
    wraps at 2^32), then `hash_bucket`."""
    f = sparse_ids.shape[-1]
    salt = torch.arange(f, dtype=torch.int64, device=sparse_ids.device) * 0x1000193
    salted = ((sparse_ids.long() & _M32) + (salt[None, :] & _M32)) & _M32
    return hash_bucket(salted, cfg.field_vocab * 4)


def wide_deep_forward(cfg: RecsysConfig, params, sparse_ids, dense_feats) -> torch.Tensor:
    b = sparse_ids.shape[0]
    ids = _wd_flat_ids(cfg, sparse_ids).long()  # [B, F]
    emb = params["embed"][ids]  # [B, F, D]
    wide = params["wide"][ids][..., 0].sum(dim=-1)  # [B]
    wide = wide + (dense_feats @ params["dense_wide"])[:, 0]
    deep_in = torch.cat([emb.reshape(b, -1), dense_feats], dim=-1)
    deep = mlp_apply(params["deep"], deep_in, act=torch.relu)[..., 0]
    return wide + deep


# ---------------------------------------------------------------------------
# uniform front-end
# ---------------------------------------------------------------------------

_INIT = {"din": din_init, "dien": dien_init, "sasrec": sasrec_init, "wide_deep": wide_deep_init}


def init_params(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    """Random parameters of ``cfg.kind`` from ``generator`` on ``device``,
    with the reference's shapes and scales (its draws differ: another
    generator)."""
    return _INIT[cfg.kind](cfg, generator, device)


def forward(cfg: RecsysConfig, params, batch: dict) -> torch.Tensor:
    """Ranking logits [B]."""
    if cfg.kind == "din":
        return din_forward(cfg, params, batch["hist"], batch["target"])
    if cfg.kind == "dien":
        return dien_forward(cfg, params, batch["hist"], batch["target"])
    if cfg.kind == "sasrec":
        return sasrec_forward(cfg, params, batch["hist"], batch["target"])
    if cfg.kind == "wide_deep":
        return wide_deep_forward(cfg, params, batch["sparse"], batch["dense"])
    raise ValueError(cfg.kind)


def retrieval_topk(cfg: RecsysConfig, params, batch: dict, k: int = 100):
    """Each query row against the candidate pool ``batch["candidates"]``
    [C]: (scores [B, K], candidate ids [B, K]). The reference takes B = 1."""
    cands = batch["candidates"]  # [C]
    if cfg.kind == "din":
        scores = din_retrieval_scores(cfg, params, batch["hist"], cands)  # [B, C]
        vals, idx = torch.topk(scores, k, dim=1)
        return vals, cands[idx]
    if cfg.kind in ("sasrec", "dien"):
        tower = sasrec_user_vector if cfg.kind == "sasrec" else dien_user_vector
        u = tower(cfg, params, batch["hist"])  # [B, D]
        cand_emb = params["items"][cands.long()]  # [C, D]
    elif cfg.kind == "wide_deep":
        # two-tower factorisation: the user tower over the non-item fields,
        # the item tower the shared embedding rows of the candidates
        u_sparse, dense = batch["sparse"], batch["dense"]
        emb = params["embed"][_wd_flat_ids(cfg, u_sparse).long()]
        deep_in = torch.cat([emb.reshape(u_sparse.shape[0], -1), dense], dim=-1)
        # the first deep layer's first embed_dim columns project the user
        u = deep_in @ params["deep"][0]["w"][:, : cfg.embed_dim]  # [B, D]
        cand_emb = params["embed"][_wd_flat_ids(cfg, cands[:, None])[:, 0].long()]
    else:
        raise ValueError(cfg.kind)
    out = topk_streaming(u, cand_emb, k, block_items=8192)
    return out.scores, cands[out.indices.long()]
