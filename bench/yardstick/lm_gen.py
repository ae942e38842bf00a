"""Inputs of the FOPO-LM cells, made on the device from a seed in a few
large calls, by the benchmark itself (nothing of the program):

- `afmoe_params` lays out AFMoE's parameters as the program takes them
  (`repro_torch.models.lm.init_params` of an `AFMoEConfig`): every
  matrix N(0, 1 / fan_in) in fp32, every norm scale 0 (unit gain).
- `clustered_unembedding` is the frozen output embedding, the catalog:
  rows around ``clusters`` unit centres, spread ``spread`` (the norm of a
  row's own part against its centre's), as a trained unembedding groups
  its tokens. On isotropic random rows a hidden state's nearest IVF
  centroids are those of near-empty lists, so the probe would read almost
  nothing (`tools/probe_lm_catalog.py` reads both).
- `zipf_tokens` draws token ids Zipf(a)-skewed over the vocabulary
  through a seeded permutation.
"""
from __future__ import annotations

import math

import torch

__all__ = ["afmoe_params", "clustered_unembedding", "zipf_tokens"]


def _mat(shape, fan_in, gen):
    return torch.randn(shape, generator=gen, device=gen.device).div_(math.sqrt(fan_in))


def afmoe_params(c: dict, gen: torch.Generator) -> dict:
    """The trainable tree for configuration ``c`` (the keys of
    `bench/configs/trinity-mini.json`): `embed`, `final_norm`, `layers`
    (every layer's attention and norms), `dense_layers`, `moe_layers`
    (the router over every expert, the held and the shared experts)."""
    d, dh, h = c["hidden_size"], c["head_dim"], c["num_attention_heads"]
    kv, n, nd = c["num_key_value_heads"], c["num_hidden_layers"], c["num_dense_layers"]
    nm, f, ff = n - nd, c["moe_intermediate_size"], c["intermediate_size"]
    held = c["held_experts"][1] - c["held_experts"][0]
    sh = c["num_shared_experts"]
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {
        "embed": _mat((c["vocab_size"], d), d, gen),
        "final_norm": zeros(d),
        "layers": {
            "attn_norm": zeros(n, d), "post_attn_norm": zeros(n, d), "mlp_norm": zeros(n, d),
            "post_mlp_norm": zeros(n, d), "q_norm": zeros(n, dh), "k_norm": zeros(n, dh),
            "wq": _mat((n, d, h * dh), d, gen), "wk": _mat((n, d, kv * dh), d, gen),
            "wv": _mat((n, d, kv * dh), d, gen), "wg": _mat((n, d, h * dh), d, gen),
            "wo": _mat((n, h * dh, d), h * dh, gen),
        },
        "dense_layers": {
            "w_gate": _mat((nd, d, ff), d, gen), "w_up": _mat((nd, d, ff), d, gen),
            "w_down": _mat((nd, ff, d), ff, gen),
        },
        "moe_layers": {
            "router": _mat((nm, d, c["num_experts_published"]), d, gen),
            "we_gate": _mat((nm, held, d, f), d, gen), "we_up": _mat((nm, held, d, f), d, gen),
            "we_down": _mat((nm, held, f, d), f, gen),
            "ws_gate": _mat((nm, sh, d, f), d, gen), "ws_up": _mat((nm, sh, d, f), d, gen),
            "ws_down": _mat((nm, sh, f, d), f, gen),
        },
    }


def clustered_unembedding(vocab: int, d: int, clusters: int, spread: float,
                          gen: torch.Generator) -> torch.Tensor:
    """[V, d] fp32: row v = centre[c_v] + spread * n_v / sqrt(d), the
    centres unit vectors, c_v uniform, n_v standard normal."""
    dev = gen.device
    centres = torch.randn((clusters, d), generator=gen, device=dev)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    assign = torch.randint(0, clusters, (vocab,), generator=gen, device=dev)
    rows = torch.randn((vocab, d), generator=gen, device=dev).mul_(spread / math.sqrt(d))
    return rows.add_(centres[assign])


def zipf_tokens(n: int, length: int, vocab: int, a: float, gen: torch.Generator) -> torch.Tensor:
    """[n, length] int64 token ids, p(rank r) ~ r^-a, ranks mapped to ids by
    a seeded permutation."""
    dev = gen.device
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks.pow(-a), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n, length), generator=gen, device=dev, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    return torch.randperm(vocab, generator=gen, device=dev)[rank]
