"""Carry weights and indexes across from the reference package.

Every function takes numpy arrays only (a caller holding JAX arrays
passes ``np.asarray`` of them), so this module imports neither JAX nor
the reference, and returns CPU tensors; the entry points move them to
their device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.mips.ivf import IVFIndex
from repro_torch.mips.refresh import RefreshState
from repro_torch.models.lm import KVCache

__all__ = [
    "adam_state_from_numpy",
    "ivf_index_from_numpy",
    "kv_cache_from_numpy",
    "linear_tower_params_from_numpy",
    "lm_params_from_numpy",
    "recsys_params_from_numpy",
    "refresh_state_from_numpy",
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _leaf(a) -> torch.Tensor:
    """``a`` as a tensor of its dtype; numpy's bfloat16 (ml_dtypes), which
    `torch.from_numpy` does not take, goes across bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _t(a.view(np.int16)).view(torch.bfloat16)
    return _t(a)


def _tree(x):
    """A tree of dicts and lists of numpy leaves as the same tree of
    tensors (bf16 leaves bit for bit)."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    return _leaf(x)


def recsys_params_from_numpy(tree: dict) -> dict:
    """The reference's `recsys.init_params` tree of any kind (leaves as
    numpy arrays) as the port's parameters, the same layout: DIN's
    `items` / `attn_mlp` / `mlp`, DIEN's `items` / `gru1` / `augru` (GRU
    dicts) / `attn_w` / `mlp`, Wide&Deep's `embed` / `wide` /
    `dense_wide` / `deep`, SASRec's `items` / `pos` / `blocks`; an MLP is
    a list of {"w", "b"} layers."""
    return _tree(tree)


def lm_params_from_numpy(tree: dict) -> dict:
    """The reference's `lm.init_params` tree (leaves as numpy arrays) as
    the port's LM parameters, the same layout: `embed`, `final_norm`,
    `unembed` when the embedding is not tied, and `layers` with every
    leaf stacked [n_layers, ...]. bf16 leaves (numpy's ml_dtypes
    bfloat16) come across as torch.bfloat16, bit for bit."""

    out = {k: _leaf(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: _leaf(v) for k, v in tree["layers"].items()}
    return out


def kv_cache_from_numpy(k, v, length) -> KVCache:
    """A `KVCache` from the reference's ([n_layers, B, S, KV, Dh] k and v,
    the filled length)."""
    return KVCache(k=_leaf(k), v=_leaf(v), length=int(length))


def ivf_index_from_numpy(centroids, lists, list_embs, num_items: int) -> IVFIndex:
    """An `IVFIndex` from its arrays ([C, L], [C, cap] int32, [C, cap, L])."""
    return IVFIndex(
        centroids=_t(centroids),
        lists=_t(np.asarray(lists, dtype=np.int32)),
        list_embs=_t(list_embs),
        num_items=int(num_items),
    )


def refresh_state_from_numpy(**arrays) -> RefreshState:
    """A `RefreshState` from its fields as numpy arrays, by name."""
    return RefreshState(**{f: _t(arrays[f]) for f in RefreshState._fields})


def linear_tower_params_from_numpy(tree: dict) -> dict:
    """The reference's `linear_tower_init` tree ({"w": [L, L]}) as the
    port's linear-tower parameters."""
    return {"w": _t(np.asarray(tree["w"], dtype=np.float32))}


def adam_state_from_numpy(state: dict) -> dict:
    """The reference's `adam` state ({"step", "m", "v"}, the moments
    trees shaped like the parameters) as the port's, so that both
    optimizers continue from the same point. Moments keep their dtype
    (bf16 ones bit for bit)."""
    return {
        "step": _t(np.asarray(state["step"], dtype=np.int32)),
        "m": _tree(state["m"]),
        "v": _tree(state["v"]),
    }
