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

__all__ = [
    "ivf_index_from_numpy",
    "refresh_state_from_numpy",
    "sasrec_params_from_numpy",
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def sasrec_params_from_numpy(tree: dict) -> dict:
    """The reference's `sasrec_init` tree (leaves as numpy arrays) as the
    port's SASRec parameters: `items`, `pos`, and per block
    `wq`/`wk`/`wv`/`ffn`/`ln1`/`ln2` (ffn a list of {"w", "b"})."""
    return {
        "items": _t(tree["items"]),
        "pos": _t(tree["pos"]),
        "blocks": [
            {
                "wq": _t(blk["wq"]),
                "wk": _t(blk["wk"]),
                "wv": _t(blk["wv"]),
                "ffn": [{"w": _t(l["w"]), "b": _t(l["b"])} for l in blk["ffn"]],
                "ln1": _t(blk["ln1"]),
                "ln2": _t(blk["ln2"]),
            }
            for blk in tree["blocks"]
        ],
    }


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
