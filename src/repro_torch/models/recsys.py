"""Recsys models of the port: SASRec, the serving slice's user tower.

Parameters are plain trees of tensors with the reference's layout
(`items`, `pos`, and per block `wq`/`wk`/`wv`/`ffn`/`ln1`/`ln2`), so
`repro_torch.convert.sasrec_params_from_numpy` carries the reference's
weights across one to one. DIN, DIEN and Wide&Deep come with a later
slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.configs_base import RecsysConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, rms_norm

__all__ = ["init_params", "sasrec_init", "sasrec_user_vector"]


def _hist_embed(table: torch.Tensor, hist: torch.Tensor):
    """[B, T] padded ids (-1 = empty) -> ([B, T, D], [B, T] mask)."""
    mask = hist >= 0
    emb = table[hist.clamp(min=0).long()]
    return emb * mask[..., None], mask


def sasrec_init(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    """Random SASRec parameters, drawn from ``generator`` on ``device``
    with the reference's scales (its draws differ: another generator)."""
    d = cfg.embed_dim
    params = {
        "items": torch.randn(
            (cfg.item_vocab, d), generator=generator, device=device
        ) / d**0.5,
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


def init_params(cfg: RecsysConfig, generator: torch.Generator, device) -> Any:
    if cfg.kind != "sasrec":
        raise NotImplementedError(
            f"{cfg.kind} is not ported yet: the recsys models beyond SASRec "
            "come with the models slice"
        )
    return sasrec_init(cfg, generator, device)


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
