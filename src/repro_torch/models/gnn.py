"""GraphCast-style encode-process-decode message-passing GNN (the
reference's `repro/models/gnn.py`).

  encoder:   node MLP  d_feat -> d_hidden
  processor: num_layers rounds of
               m_e  = MLP([h_src, h_dst])           (edge update)
               h_v' = h_v + MLP([h_v, agg_e->v m_e]) (node update, residual)
  decoder:   node MLP  d_hidden -> n_vars (regression; GraphCast's 227
             surface/atmo variables)

Each shape cell brings its own graph, so the model is graph-agnostic:
edges arrive as padded (src, dst) int arrays (-1 = padding). A padded id
is clamped to 0 before the gather and its message is zeroed (or set to
-inf for ``max``), as the reference does.

Message passing is plain torch, the reference's `jnp.take` plus
`jax.ops.segment_*`: `index_select` gathers the endpoints, `index_add`
sums the messages onto their destinations (``sum``; ``mean`` divides by
the valid in-degree, floored at 1) and `scatter_reduce(..., "amax",
include_self=False)` takes their maximum (``max``: a node that no valid
edge reaches stays -inf there and is mapped to 0, the reference's
`isfinite` rule; tied maxima share the gradient evenly in both). On
CUDA `index_add` adds with atomics, so a ``sum`` or ``mean`` step is not
bitwise repeatable run to run.

The processor's MLPs are stacked [num_layers, ...] leaves
(``params["edge_mlps"]`` and ``params["node_mlps"]``, each a list of
{"w", "b"} layers). ``cfg.scan_layers`` with ``cfg.remat`` checkpoints
each layer (`torch.utils.checkpoint`, non-reentrant), the reference's
`jax.checkpoint` inside its `lax.scan`; without ``remat``, or with
``scan_layers=False`` (the reference's unrolled loop), every layer keeps
its activations. The numbers are the same either way.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.configs_base import GNNConfig
from repro_torch.models.layers import mlp_apply, mlp_init
from repro_torch.optim.optimizers import grad_like, value_and_grad

__all__ = ["abstract_params", "forward", "init_params", "loss_fn", "make_train_step",
           "static_shape", "subgraph_inputs"]


def init_params(cfg: GNNConfig, generator: torch.Generator, d_feat: int | None = None,
                device=None) -> Any:
    """Random parameters: N(0, 1 / fan_in) weights drawn from
    ``generator`` (on its device unless ``device`` says otherwise), zero
    biases, the reference's layout and shapes (its draws differ: another
    generator)."""
    dev = device if device is not None else generator.device
    d_in = d_feat or cfg.d_feat
    dh = cfg.d_hidden
    params = {
        "encoder": mlp_init((d_in, dh, dh), generator, dev),
        "decoder": mlp_init((dh, dh, cfg.n_vars), generator, dev),
    }
    for name in ("edge_mlps", "node_mlps"):
        per_layer = [mlp_init((2 * dh, dh, dh), generator, dev) for _ in range(cfg.num_layers)]
        params[name] = [
            {k: torch.stack([layer[j][k] for layer in per_layer]) for k in ("w", "b")}
            for j in range(2)
        ]
    return params


def abstract_params(cfg: GNNConfig, d_feat: int) -> Any:
    """The parameter tree's shapes and dtypes, on the meta device (the
    reference's `jax.eval_shape` of `init_params`)."""
    return init_params(cfg, torch.Generator(), d_feat, device="meta")


def _layers(params) -> list[tuple[list[dict], list[dict]]]:
    """Per-layer (edge MLP, node MLP) views of the stacked leaves. `unbind`
    makes them in one op, whose backward stacks the layers' gradients once
    (a view per `w[i]` would add a zero-filled full-size gradient per
    layer)."""
    def split(mlp):
        per = [{k: [grad_like(x) for x in v.unbind(0)] for k, v in layer.items()}
               for layer in mlp]
        n = len(per[0]["w"])
        return [[{k: v[i] for k, v in layer.items()} for layer in per] for i in range(n)]

    return list(zip(split(params["edge_mlps"]), split(params["node_mlps"])))


def _aggregate(cfg: GNNConfig, m: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               n: int) -> torch.Tensor:
    """Messages m [E, dh] (zero at padded edges) reduced onto their
    destination nodes: [n, dh]."""
    if cfg.aggregator == "sum":
        return m.new_zeros((n, m.shape[1])).index_add(0, dst, m)
    if cfg.aggregator == "mean":
        s = m.new_zeros((n, m.shape[1])).index_add(0, dst, m)
        c = m.new_zeros((n,)).index_add(0, dst, valid.to(m.dtype))
        return s / torch.clamp(c[:, None], min=1.0)
    if cfg.aggregator == "max":
        neg = torch.where(valid[:, None], m, float("-inf"))
        agg = torch.full((n, m.shape[1]), float("-inf"), dtype=m.dtype, device=m.device)
        agg = agg.scatter_reduce(0, dst[:, None].expand_as(neg), neg, "amax",
                                 include_self=False)
        return torch.where(torch.isfinite(agg), agg, 0.0)
    raise ValueError(cfg.aggregator)


def forward(
    cfg: GNNConfig,
    params: Any,
    node_feats: torch.Tensor,  # [N, d_feat]
    edge_src: torch.Tensor,  # [E] int, -1 pad
    edge_dst: torch.Tensor,  # [E] int, -1 pad
) -> torch.Tensor:
    """Per-node predictions [N, n_vars]."""
    n = node_feats.shape[0]
    valid = (edge_src >= 0) & (edge_dst >= 0)
    src = edge_src.clamp(min=0).long()
    dst = edge_dst.clamp(min=0).long()

    h = mlp_apply(params["encoder"], node_feats)  # [N, dh]

    def layer(h_, edge_mlp, node_mlp):
        m_in = torch.cat([h_.index_select(0, src), h_.index_select(0, dst)], dim=-1)  # [E, 2dh]
        m = mlp_apply(edge_mlp, m_in)  # [E, dh]
        m = torch.where(valid[:, None], m, 0.0)
        agg = _aggregate(cfg, m, dst, valid, n)
        return h_ + mlp_apply(node_mlp, torch.cat([h_, agg], dim=-1))

    remat = cfg.scan_layers and cfg.remat
    for edge_mlp, node_mlp in _layers(params):
        if remat:
            h = checkpoint(layer, h, edge_mlp, node_mlp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = layer(h, edge_mlp, node_mlp)

    return mlp_apply(params["decoder"], h)  # [N, n_vars]


def loss_fn(cfg: GNNConfig, params, node_feats, edge_src, edge_dst, targets,
            node_mask=None) -> torch.Tensor:
    """Mean squared error over the nodes, or over the masked ones:
    sum(err * mask) / max(sum(mask) * n_vars, 1)."""
    pred = forward(cfg, params, node_feats, edge_src, edge_dst)
    err = torch.square(pred - targets)
    if node_mask is not None:
        err = err * node_mask[:, None]
        return torch.sum(err) / torch.clamp(torch.sum(node_mask) * cfg.n_vars, min=1.0)
    return torch.mean(err)


def make_train_step(cfg: GNNConfig, optimizer):
    """(params, opt_state, node_feats, edge_src, edge_dst, targets,
    node_mask) -> (params, opt_state, loss)."""

    def train_step(params, opt_state, node_feats, edge_src, edge_dst, targets, node_mask):
        loss, grads = value_and_grad(
            lambda p: loss_fn(cfg, p, node_feats, edge_src, edge_dst, targets, node_mask),
            params,
        )
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def static_shape(cell) -> tuple[int, int]:
    """The (nodes, edges) a GNN shape cell's step runs at, each padded to
    a multiple of 512 (the reference's `repro/launch/specs.py:
    _gnn_program`): a sampled minibatch's worst-case two-hop subgraph, a
    batch of small graphs laid out block-diagonally, or the cell's
    graph. Every step of a cell hands the device these shapes."""
    if cell.batch_nodes:
        n = cell.batch_nodes * (1 + cell.fanout[0] + cell.fanout[0] * cell.fanout[1])
        e = cell.batch_nodes * (cell.fanout[0] + cell.fanout[0] * cell.fanout[1])
    elif cell.global_batch:
        n, e = cell.n_nodes * cell.global_batch, cell.n_edges * cell.global_batch
    else:
        n, e = cell.n_nodes, cell.n_edges
    return -(-n // 512) * 512, -(-e // 512) * 512


def subgraph_inputs(sub, feats: torch.Tensor, targets: torch.Tensor, n: int, e: int) -> tuple:
    """A sampled subgraph (`repro_torch.data.sample_neighbors`) as a
    step's inputs at the static ``(n, e)`` of `static_shape`: its nodes'
    rows gathered from the ``feats`` and ``targets`` tables on their
    device (zero rows past them), its local edges padded with -1, and the
    loss mask on its seeds. Returns (node_feats, edge_src, edge_dst,
    targets, node_mask)."""
    m, k = len(sub.node_ids), len(sub.edge_src)
    if m > n or k > e:
        raise ValueError(f"a subgraph of {m} nodes and {k} edges does not fit ({n}, {e})")
    dev = feats.device
    ids = torch.from_numpy(sub.node_ids).to(dev)
    x = feats.new_zeros((n, feats.shape[1]))
    x[:m] = feats.index_select(0, ids)
    y = targets.new_zeros((n, targets.shape[1]))
    y[:m] = targets.index_select(0, ids)
    edges = torch.full((2, e), -1, dtype=torch.int32)
    edges[0, :k] = torch.from_numpy(sub.edge_src)
    edges[1, :k] = torch.from_numpy(sub.edge_dst)
    src, dst = edges.to(dev)
    mask = (torch.arange(n, device=dev) < sub.num_seeds).to(feats.dtype)
    return x, src, dst, y, mask
