"""Sharding-spec trees for the production meshes (the reference's
`repro/dist/sharding.py`; the runtime half of `repro_torch.dist` is
`dist.fopo`).

A spec is the reference's PartitionSpec written as a tuple: one entry a
tensor dimension, each entry None (replicated), a mesh axis name, or a
tuple of axis names. The builders below mirror a model's parameter or
cache tree with such tuples, entry for entry as the reference's, so the
two can be compared exactly; `to_placements` turns one into DTensor
placements on a `DeviceMesh` whose dimensions carry the axis names
(`launch.mesh`; `mesh_axes`).

`AXIS_SIZES` is the production mesh's extent per axis: a 16 x 16 (data x
model) pod, doubled by a leading pure-DP `pod` axis in the multi-pod
mesh. Every rule is divisibility-guarded: a dim is sharded over an axis
only when the axis size divides it (`_guard`), otherwise it is
replicated, so one table serves every architecture (Gemma-2's 4 KV heads
cannot split 16 ways; OLMoE's 16 can).
"""
from __future__ import annotations

import math
from typing import Any

__all__ = [
    "AXIS_SIZES",
    "MODEL_AXIS",
    "axis_product",
    "gnn_param_specs",
    "lm_cache_specs",
    "lm_param_specs",
    "mesh_axes",
    "recsys_param_specs",
    "to_placements",
    "tree_map_with_path",
    "zip_map",
]

# Production mesh axis extents (launch.mesh.make_production_mesh):
# single pod = (data=16, model=16); multi-pod adds pod=2 in front.
AXIS_SIZES: dict[str, int] = {"pod": 2, "data": 16, "model": 16}

MODEL_AXIS = "model"


def axis_product(axes) -> int:
    """Total device count behind a spec entry (None -> 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return AXIS_SIZES[axes]
    return math.prod(AXIS_SIZES[a] for a in axes)


def _guard(dim: int, axes):
    """Shard `dim` over `axes` only if the mesh extent divides it."""
    return axes if (axes is not None and dim % axis_product(axes) == 0) else None


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _replicated(leaf) -> tuple:
    return (None,) * len(_shape(leaf))


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and NamedTuples
    (a path holds dict keys and NamedTuple fields as names, list indices
    as their decimal strings, as the reference's `_path_names`)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and the spec tree that mirrors it,
    walked by the tree's structure (a spec, itself a tuple, is a leaf)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, getattr(tree, f), getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs, strict=True))
    return fn(tree, specs)


def mesh_axes(mesh) -> list[tuple[str, ...]]:
    """The axes each dimension of ``mesh`` holds, by its name: "model",
    or "pod+data", the multi-pod mesh's pure-DP pod and data axes as one
    dimension (`launch.mesh`)."""
    return [tuple(name.split("+")) for name in mesh.mesh_dim_names]


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` for a spec: each mesh dimension whose
    axes an entry holds shards that entry's tensor dimension (an entry of
    several axes, such as ("data", "model"), shards its dimension on each
    of their mesh dimensions, major to minor in mesh order); every other
    mesh dimension replicates."""
    from torch.distributed.tensor import Replicate, Shard

    dims = mesh_axes(mesh)
    out = [Replicate() for _ in dims]
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        rest = list(axes)
        for m, held in enumerate(dims):
            if all(a in axes for a in held):
                out[m] = Shard(dim)
                for a in held:
                    rest.remove(a)
        if rest:
            raise ValueError(f"spec {spec} names axes {rest} that no dimension of the mesh "
                             f"{mesh.mesh_dim_names} holds alone")
    return out


# ---------------------------------------------------------------------------
# LM family: megatron-style tensor parallelism over `model`
# ---------------------------------------------------------------------------

# name -> index of the dim sharded over `model`. Layer-stacked leaves
# carry a leading [n_layers] dim, which is never sharded. Column-parallel
# projections shard their output features; row-parallel ones the
# contraction dim, so activations stay sharded between a block's two
# products.
_LM_MODEL_DIM = {
    "wq": 2,  # [n, d, H*dh]   column-parallel (heads)
    "wk": 2,  # [n, d, KV*dh]
    "wv": 2,  # [n, d, KV*dh]
    "wo": 1,  # [n, H*dh, d]   row-parallel
    "w_gate": 2,  # [n, d, d_ff]  column-parallel
    "w_up": 2,  # [n, d, d_ff]
    "w_down": 1,  # [n, d_ff, d]  row-parallel
    "we_gate": 3,  # [n, E, d, eff] expert-inner column-parallel
    "we_up": 3,  # [n, E, d, eff]
    "we_down": 2,  # [n, E, eff, d] expert-inner row-parallel
    "embed": 0,  # [V, d]        vocab rows (the FOPO beta layout)
    "unembed": 0,  # [V, d]
}
# router [n, d, E], norms [n, d] / [d]: replicated (tiny, latency-bound).


def lm_param_specs(params: Any) -> Any:
    """Spec tree mirroring `models.lm` params: tensor-parallel over
    `model`, divisibility-guarded per leaf, replicated otherwise."""

    def spec(path, leaf):
        dim = _LM_MODEL_DIM.get(path[-1])
        shape = _shape(leaf)
        if dim is None or dim >= len(shape):
            return _replicated(leaf)
        axes = [None] * len(shape)
        axes[dim] = _guard(shape[dim], MODEL_AXIS)
        return tuple(axes)

    return tree_map_with_path(spec, params)


def lm_cache_specs(cache: Any, batch_axis, model_axis=MODEL_AXIS, *, cache_axes=None) -> Any:
    """KV-cache spec tree: k / v are [n_layers, B, S, KV, Dh]. Batch is
    sharded over ``batch_axis`` (None for serving cells whose batch does
    not divide the DP extent), the head side over ``model_axis``: KV heads
    when they divide the axis, else the head_dim. The layer and sequence
    dims are never sharded. The port's `length` is a Python int, a
    0-dim leaf here: its spec is ().

    ``cache_axes`` overrides the head-side rule per cell:

      None    the auto rule (KV heads first, Dh fallback)
      "kv"    shard KV heads only (Dh never), divisibility-guarded
      "dh"    shard head_dim only, divisibility-guarded
      "none"  replicate both head dims
    """
    if cache_axes not in (None, "kv", "dh", "none"):
        raise ValueError(
            f"cache_axes must be None, 'kv', 'dh' or 'none', got {cache_axes!r}"
        )

    def spec(_, leaf):
        shape = _shape(leaf)
        if len(shape) != 5:  # `length`
            return _replicated(leaf)
        _, b, _, kv, dh = shape
        if cache_axes == "none":
            kv_ax = dh_ax = None
        elif cache_axes == "kv":
            kv_ax, dh_ax = _guard(kv, model_axis), None
        elif cache_axes == "dh":
            kv_ax, dh_ax = None, _guard(dh, model_axis)
        else:
            kv_ax = _guard(kv, model_axis)
            dh_ax = _guard(dh, model_axis) if kv_ax is None else None
        return (None, _guard(b, batch_axis), None, kv_ax, dh_ax)

    return tree_map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# GNN / recsys: name overrides for the big tables and a generic
# divisibility rule for the dense stacks
# ---------------------------------------------------------------------------

# 2-D tables whose ROWS are the natural shard dim (catalog / vocab rows,
# the layout the sharded MIPS retriever and the dist FOPO step assume for
# beta).
_ROW_SHARDED_TABLES = {"items", "embed", "wide"}


def _generic_matrix_spec(leaf) -> tuple:
    """Dense weights (possibly layer-stacked): shard the last dim over
    `model` when divisible (column-parallel), else the second-to-last
    (row-parallel), else replicate. 0/1-D leaves replicate."""
    shape = _shape(leaf)
    if len(shape) < 2:
        return _replicated(leaf)
    axes = [None] * len(shape)
    if _guard(shape[-1], MODEL_AXIS):
        axes[-1] = MODEL_AXIS
    elif _guard(shape[-2], MODEL_AXIS):
        axes[-2] = MODEL_AXIS
    return tuple(axes)


def gnn_param_specs(params: Any) -> Any:
    """Spec tree for `models.gnn` params: the MLP weights shard their
    hidden features over `model` (d_hidden=512 divides 16); biases and the
    ragged decoder head replicate."""

    def spec(path, leaf):
        if path[-1] == "b":
            return _replicated(leaf)
        return _generic_matrix_spec(leaf)

    return tree_map_with_path(spec, params)


def recsys_param_specs(params: Any) -> Any:
    """Spec tree for `models.recsys` params: the million-row item and
    hashed-field tables shard their rows over `model`; the small dense
    stacks use the generic guarded rule."""

    def spec(path, leaf):
        shape = _shape(leaf)
        if path[-1] in _ROW_SHARDED_TABLES and len(shape) == 2:
            return (_guard(shape[0], MODEL_AXIS), None)
        if path[-1] == "b" or len(shape) < 2:
            return _replicated(leaf)
        return _generic_matrix_spec(leaf)

    return tree_map_with_path(spec, params)
