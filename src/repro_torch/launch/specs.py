"""Cell programs (the reference's `repro/launch/specs.py`): for every
(arch x shape) cell, the step function, its abstract inputs (meta
tensors: shapes and dtypes, never allocated) and their sharding specs.
The dry run (`launch.dryrun`) consumes them.

The step functions are the port's own (`lm.make_train_step`,
`lm.prefill`, `lm.decode_step`, `gnn.make_train_step`,
`recsys.make_train_step`, `recsys.forward`, `recsys.retrieval_topk`,
`optim.optimizers.adam`), so a program runs the code the trainers and
the servers run. Specs are the reference's PartitionSpecs as tuples
(`dist.sharding`), entry for entry; `distribute` lays meta arguments out
on a mesh as DTensors by them.

Two arguments differ from the reference's by design: the recsys train
step takes an int seed where the reference takes a [2] uint32 key (spec
()), and the KV cache's `length` is an int where the reference has a
0-dim int32 (spec () in both).

`build_program` also takes ``num_layers`` and ``n_micro``: the same
program with fewer layers or microbatches (global batch = n_micro x
microbatch), which the dry run traces in place of the full one where it
extrapolates along the loops (`launch.dryrun.trace_points`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs import get_arch
from repro_torch.dist.sharding import (
    AXIS_SIZES,
    gnn_param_specs,
    lm_cache_specs,
    lm_param_specs,
    recsys_param_specs,
    to_placements,
    zip_map,
)
from repro_torch.launch import costs
from repro_torch.models import gnn, lm, recsys
from repro_torch.models.configs_base import ShapeCell
from repro_torch.optim.optimizers import adam

__all__ = ["CellProgram", "build_program", "distribute", "input_specs"]


class CellProgram(NamedTuple):
    arch_id: str
    shape_name: str
    fn: Any  # the step function
    args: tuple  # abstract arguments (trees of meta tensors)
    in_specs: tuple  # spec trees, aligned with args
    out_specs: Any  # spec tree or None
    donate_argnums: tuple
    model_flops: float
    loop_trips: tuple = ()  # the loops' trip counts, outermost first
    note: str = ""


def _abstract(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _dp(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def _opt_specs(param_specs):
    return {"step": (), "m": param_specs, "v": param_specs}


def _adam(lr: float, moments_dtype=None):
    """`optimizers.adam`, its update marked as the step's "update" phase
    for the walker's memory peaks (`jaxpr_cost.phase`)."""
    from repro_torch.launch.jaxpr_cost import phase

    opt = adam(lr, moments_dtype=None if moments_dtype is None else lm._dtype(moments_dtype))

    def update(*args):
        with phase("update"):
            return opt.update(*args)

    return opt._replace(update=update)


def _unwrapped(fn):
    """``fn`` without its `torch.inference_mode` decorator: DTensor cannot
    make its wrappers under inference mode, so the serving steps run
    under `torch.no_grad` on a mesh (the same ops)."""
    return getattr(fn, "__wrapped__", fn)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_program(arch_id, mod, cell: ShapeCell, multi_pod: bool, opt: bool = False,
                num_layers: int | None = None, n_micro: int | None = None) -> CellProgram:
    cfg = mod.CONFIG
    dp = _dp(multi_pod)
    if opt:
        # the reference's optimised variant: the flash kernel for train and
        # prefill (sharded over batch = dp, heads = model), grouped-einsum
        # GQA decode, no remat in training
        flash_axes = ("pod", "data") if multi_pod else ("data",)
        cfg = dataclasses.replace(
            cfg,
            use_flash_kernel=cell.kind in ("train", "prefill"),
            flash_axes=flash_axes,
            decode_gqa_einsum=True,
            remat=not (cell.kind == "train"),
            pair_scan=cfg.local_global_alternating
            and (cell.kind != "decode" or cell.global_batch >= 16),
        )
    flops = costs.lm_model_flops(cfg, cell)
    full_layers = cfg.num_layers
    mb = cfg.microbatch or cell.global_batch
    full_micro = max(1, cell.global_batch // mb)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if n_micro is not None and cell.kind == "train":
        cell = dataclasses.replace(cell, global_batch=n_micro * mb)
    params = lm.abstract_params(cfg)
    pspecs = lm_param_specs(params)
    chunks = max(1, -(-cell.seq_len // 1024))

    if cell.kind == "train":
        optimizer = _adam(1e-4, cfg.moments_dtype)
        opt_state = optimizer.init(params)
        step = lm.make_train_step(cfg, optimizer)
        tokens = _abstract((cell.global_batch, cell.seq_len), torch.int32)
        labels = _abstract((cell.global_batch, cell.seq_len), torch.int32)
        return CellProgram(
            arch_id, cell.name, step,
            (params, opt_state, tokens, labels),
            (pspecs, _opt_specs(pspecs), (dp, None), (dp, None)),
            (pspecs, _opt_specs(pspecs), ()),
            donate_argnums=(0, 1),
            model_flops=flops,
            loop_trips=(full_micro, full_layers, chunks, chunks),
        )

    batch_axis = dp if cell.global_batch % (32 if multi_pod else 16) == 0 else None
    if cell.kind == "prefill":
        cache = lm.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        cspecs = lm_cache_specs(cache, batch_axis, "model")
        tokens = _abstract((cell.global_batch, cell.seq_len), torch.int32)

        def prefill(params_, tokens_, cache_):
            with torch.no_grad():
                return _unwrapped(lm.prefill)(cfg, params_, tokens_, cache_)

        return CellProgram(
            arch_id, cell.name, prefill,
            (params, tokens, cache),
            (pspecs, (batch_axis, None), cspecs),
            ((batch_axis, "model"), cspecs),
            donate_argnums=(2,),
            model_flops=flops,
            loop_trips=(full_layers, chunks, chunks),
        )

    if cell.kind == "decode":
        cache = lm.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        # GQA archs (KV heads < model axis) replicate the head dims in
        # decode: rope's rotate-half crosses a Dh split
        cache_axes = "kv" if cfg.num_kv_heads % AXIS_SIZES["model"] == 0 else "none"
        cspecs = lm_cache_specs(cache, batch_axis, "model", cache_axes=cache_axes)
        token = _abstract((cell.global_batch,), torch.int32)

        def decode(params_, token_, cache_):
            with torch.no_grad():
                return _unwrapped(lm.decode_step)(cfg, params_, token_, cache_)

        return CellProgram(
            arch_id, cell.name, decode,
            (params, token, cache),
            (pspecs, (batch_axis,), cspecs),
            ((batch_axis, "model"), cspecs),
            donate_argnums=(2,),
            model_flops=flops,
            loop_trips=(full_layers,),
        )
    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_program(arch_id, mod, cell: ShapeCell, multi_pod: bool,
                 num_layers: int | None = None) -> CellProgram:
    cfg = mod.CONFIG
    full_layers = cfg.num_layers
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    dp = _dp(multi_pod)
    n, e = gnn.static_shape(cell)

    params = gnn.abstract_params(cfg, cell.d_feat)
    pspecs = gnn_param_specs(params)
    optimizer = _adam(1e-4)
    opt_state = optimizer.init(params)
    step = gnn.make_train_step(cfg, optimizer)

    feats = _abstract((n, cell.d_feat), torch.float32)
    src = _abstract((e,), torch.int32)
    dst = _abstract((e,), torch.int32)
    targets = _abstract((n, cfg.n_vars), torch.float32)
    mask = _abstract((n,), torch.float32)
    edge_spec = ((dp, "model") if not multi_pod else ("pod", "data", "model"),)
    return CellProgram(
        arch_id, cell.name, step,
        (params, opt_state, feats, src, dst, targets, mask),
        (pspecs, _opt_specs(pspecs), (dp, None), edge_spec, edge_spec, (dp, None), (dp,)),
        (pspecs, _opt_specs(pspecs), ()),
        donate_argnums=(0, 1),
        model_flops=costs.gnn_model_flops(mod.CONFIG, cell),
        loop_trips=(full_layers,),
    )


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _recsys_batch(cfg, b: int, with_label=True, positives=False):
    out = {}
    if cfg.kind == "wide_deep":
        out["sparse"] = _abstract((b, cfg.n_sparse), torch.int32)
        out["dense"] = _abstract((b, cfg.n_dense), torch.float32)
    else:
        out["hist"] = _abstract((b, cfg.seq_len), torch.int32)
        if not positives:
            out["target"] = _abstract((b,), torch.int32)
    if positives:
        out["positives"] = _abstract((b, 8), torch.int32)
    elif with_label:
        out["label"] = _abstract((b,), torch.float32)
    return out


def _recsys_batch_specs(cfg, dp, with_label=True, positives=False):
    out = {}
    if cfg.kind == "wide_deep":
        out["sparse"] = (dp, None)
        out["dense"] = (dp, None)
    else:
        out["hist"] = (dp, None)
        if not positives:
            out["target"] = (dp,)
    if positives:
        out["positives"] = (dp, None)
    elif with_label:
        out["label"] = (dp,)
    return out


def _recsys_program(arch_id, mod, cell: ShapeCell, multi_pod: bool,
                    opt: bool = False) -> CellProgram:
    cfg = mod.CONFIG
    dp = _dp(multi_pod)
    params = recsys.abstract_params(cfg)
    pspecs = recsys_param_specs(params)
    flops = costs.recsys_model_flops(cfg, cell)

    if cell.kind == "train":
        objective = "fopo" if cfg.kind == "sasrec" else "bce"
        optimizer = _adam(1e-3)
        opt_state = optimizer.init(params)
        plan = None
        if opt and objective == "fopo":
            # the reference's optimised variant: a top-K on each catalog
            # shard, then a merge of the shards' K, in place of the
            # streaming scan over the sharded table
            plan = dataclasses.replace(recsys.fopo_plan(cfg),
                                       retriever=_sharded_retriever(cfg.fopo_top_k))
        step = recsys.make_train_step(cfg, optimizer, objective=objective, plan=plan)
        use_pos = objective == "fopo"
        batch = _recsys_batch(cfg, cell.global_batch, positives=use_pos)
        bspecs = _recsys_batch_specs(cfg, dp, positives=use_pos)
        if cfg.kind == "sasrec":  # streaming top-K scan over the catalog
            trips = (-(-cfg.item_vocab // 8192),)
        elif cfg.kind == "dien":  # GRU/AUGRU loops over the history
            trips = (cfg.seq_len,)
        else:
            trips = ()
        return CellProgram(
            arch_id, cell.name, step,
            (params, opt_state, batch, 0),
            (pspecs, _opt_specs(pspecs), bspecs, ()),
            (pspecs, _opt_specs(pspecs), ()),
            donate_argnums=(0, 1),
            model_flops=flops,
            loop_trips=trips,
            note=f"objective={objective}",
        )

    if cell.kind == "serve":
        batch = _recsys_batch(cfg, cell.global_batch, with_label=False)
        bspecs = _recsys_batch_specs(cfg, dp, with_label=False)

        def serve(params_, batch_):
            return recsys.forward(cfg, params_, batch_)

        return CellProgram(
            arch_id, cell.name, serve,
            (params, batch),
            (pspecs, bspecs),
            (dp,),
            donate_argnums=(),
            model_flops=flops,
            loop_trips=(cfg.seq_len,) if cfg.kind == "dien" else (),
        )

    if cell.kind == "retrieval":
        batch = _recsys_batch(cfg, 1, with_label=False)
        # batch 1: replicate the query, shard the candidates
        if cfg.kind == "wide_deep":
            bspecs = {"sparse": (None, None), "dense": (None, None)}
        else:
            bspecs = {"hist": (None, None), "target": (None,)}
        cand_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        # the candidate list padded to the full mesh size (512 covers both)
        n_cand = _pad_to(cell.n_candidates, 512)
        batch["candidates"] = _abstract((n_cand,), torch.int32)
        bspecs["candidates"] = (cand_axes,)

        def retrieve(params_, batch_):
            return recsys.retrieval_topk(cfg, params_, batch_, k=100)

        trips = (-(-cell.n_candidates // 8192),) if cfg.kind != "din" else ()
        return CellProgram(
            arch_id, cell.name, retrieve,
            (params, batch),
            (pspecs, bspecs),
            ((None, None), (None, None)),
            donate_argnums=(),
            model_flops=flops,
            loop_trips=trips,
        )
    raise ValueError(cell.kind)


def _sharded_retriever(top_k: int):
    """(h [B, L], beta [P, L]) -> TopK [B, K] over DTensors: each model
    shard's own top-K of its catalog rows (ids offset to the global
    rows), then the K x model candidates merged
    (`mips.exact.merge_topk`, ties to the lower position)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.mips.exact import TopK, merge_topk

    def retriever(h, beta):
        if not isinstance(beta, DTensor):
            raise TypeError("the sharded retriever runs on a mesh (DTensor inputs)")
        mesh = beta.device_mesh
        names = mesh.mesh_dim_names
        row_pl = [Shard(0) if n == "model" else Replicate() for n in names]
        beta = beta.redistribute(mesh, row_pl)
        h_pl = [Replicate() if n == "model" else p for n, p in zip(names, h.placements)]
        h = h.redistribute(mesh, h_pl)
        cand_pl = [Shard(1) if n == "model" else p for n, p in zip(names, h_pl)]

        def local_topk(h_, beta_):
            rows = beta_.shape[0]
            first = mesh.get_local_rank("model") * rows
            s, i = torch.topk((h_ @ beta_.T).float(), min(top_k, rows), dim=1)
            return s, (i + first).to(torch.int32)

        s, i = local_map(local_topk, out_placements=(cand_pl, cand_pl),
                         in_placements=(h_pl, row_pl), device_mesh=mesh)(h, beta)
        return TopK(*merge_topk(s, i, top_k))

    return retriever


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def build_program(arch_id: str, shape_name: str, *, multi_pod: bool = False, opt: bool = False,
                  num_layers: int | None = None, n_micro: int | None = None) -> CellProgram:
    """opt=False -> the baseline program; opt=True -> the reference's
    optimised variant (the flash kernel, grouped-GQA decode, the sharded
    top-K). ``num_layers`` / ``n_micro`` cut the layer and microbatch
    loops (LM and GNN; the trips and model FLOPs stay the full cell's)."""
    mod = get_arch(arch_id)
    cell = mod.SHAPES[shape_name]
    if mod.FAMILY == "lm":
        return _lm_program(arch_id, mod, cell, multi_pod, opt=opt, num_layers=num_layers,
                           n_micro=n_micro)
    if mod.FAMILY == "gnn":
        return _gnn_program(arch_id, mod, cell, multi_pod, num_layers=num_layers)
    if mod.FAMILY == "recsys":
        return _recsys_program(arch_id, mod, cell, multi_pod, opt=opt)
    raise ValueError(mod.FAMILY)


def input_specs(arch_id: str, shape_name: str, *, multi_pod: bool = False):
    """The abstract stand-ins for every model input of the cell."""
    return build_program(arch_id, shape_name, multi_pod=multi_pod).args


def distribute(mesh, args, specs):
    """The arguments as DTensors on ``mesh`` laid out by their specs: each
    meta tensor becomes the DTensor whose local shard (rank 0's, a meta
    tensor too) has the shape its spec gives, so nothing is allocated and
    no collective runs; a real tensor becomes the DTensor whose local
    shard is the tensor itself, which needs every mesh dim it is sharded
    over to have size 1 (the card's 1 x 1 mesh). Ints stay ints."""
    from torch.distributed.tensor import DTensor, Shard

    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        pl = to_placements(spec, mesh)
        local = list(x.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] = -(-local[p.dim] // mesh.size(i))
        if x.is_meta:
            x_local = torch.empty(local, dtype=x.dtype, device=x.device)
        elif local == list(x.shape):
            x_local = x
        else:
            raise ValueError(f"a real tensor of shape {tuple(x.shape)} would be split by {pl}")
        return DTensor.from_local(x_local, mesh, pl, run_check=False, shape=x.shape,
                                  stride=x.stride())

    return zip_map(one, args, specs)
