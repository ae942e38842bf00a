"""The dry run: every (arch x shape) cell's step traced on the production
meshes, for the roofline's inputs (the reference's
`repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--opt]

Each cell's program (`launch.specs.build_program`) runs once on a fake
process group of 256 ranks (pod: data 16 x model 16) or 512 (multipod:
pod 2 x data 16 x model 16), its arguments DTensors whose local shards
are meta tensors: nothing is allocated on any device and no collective
moves data, so the dry run runs on a host without a card, as the
reference's runs on a CPU host with fake devices. It never calls
`device.resolve_device`'s CUDA check for that reason. The mesh's device
type is the card's, "cuda": DTensor picks its collectives by it. The
tensors are meta rather than
fake "cuda" ones because autograd cannot take a fake "cuda" leaf on a
build of torch without CUDA; no op on the dry run's path picks a device
branch but the flash-attention kernels, which are registered operators
with fake implementations (`kernels.flash_attention.ops`), so the trace
is the card's.

`launch.jaxpr_cost.OpCost` watches the step and gives what the
reference's row holds:

  * ``memory``: argument, output, alias (an output sharing an argument's
    storage, as the cache prefill and decode write in place: the
    reference's donated bytes) and temp bytes, and the per-device peak,
    from the live local-shard storages of rank 0 (the largest shard);
    temp is peak minus arguments;
  * ``hlo_flops`` / ``hlo_bytes_accessed``: the walker's global FLOPs and
    bytes (the reference's names; no HLO is involved);
  * ``collective_bytes`` / ``_counts`` / ``_by_depth``: the result bytes
    and calls of each kind of collective one rank issues
    (`costs.collective_bytes`);
  * ``model_flops``, ``useful_flops_ratio`` and ``roofline`` under the
    card's constants (`launch.costs`);
  * ``kernel_ops`` (the port's own): the calls of each kernel op the
    walker costed by its rule, summed over the traced programs (the
    sample sizes below where the trace is extrapolated).

``trace_s`` stands where the reference has ``lower_s`` / ``compile_s``:
nothing is lowered or compiled. The reference's two XLA cross-check
fields (``xla_per_device_*_scan_undercounted``) have no counterpart: no
compiler's own count exists to hold the walker to.

The port's loops run in Python, so a trace is unrolled. Where a cell has
a layer loop (LM, GNN) and, in LM training, a microbatch loop, the step
is traced at two layer counts and two microbatch counts, and every count, FLOPs, bytes,
collectives and memory, is taken from them as an affine function of the
layers, the microbatches and their product: exact for counts (each
layer and each microbatch runs the same ops, once the layout DTensor
gives the activations has settled, which takes the first layer: the
points are 2 and 3 layers, 2 and 4 for alternating models, and 2 and 3
microbatches), and for the memory peak of each phase of the step
(`jaxpr_cost.phase`) as long as the same moment of the phase holds its
peak at each size; the step's peak is the largest phase's.
``traced_at`` records the points. ``collective_by_depth`` splits the bytes into the part that
does not grow with the loops (depth 0), the part that grows with the
outer loop (1), and with both (2).

Rows are appended to ``results/dryrun_torch.json`` (or
``$DRYRUN_RESULTS``), never the reference's ``results/dryrun.json``; a
cell already ``ok`` or skipped is not run again unless ``--force``, and a
cell that fails is recorded with ``ok: false`` and its error while the
sweep goes on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from fractions import Fraction

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import costs, jaxpr_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_program, distribute

__all__ = ["RESULTS", "main", "run_cell", "trace_points"]

RESULTS = os.environ.get(
    "DRYRUN_RESULTS",
    os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch.json"),
)


def trace_points(arch_id: str, shape_name: str) -> dict:
    """The loops a cell's trace extrapolates along: {"layers": (full,
    (a, b)), "micro": (full, (2, 3))}, each only where the cell has it."""
    mod = get_arch(arch_id)
    cell = mod.SHAPES[shape_name]
    out = {}
    if mod.FAMILY in ("lm", "gnn"):
        step = 2 if getattr(mod.CONFIG, "local_global_alternating", False) else 1
        out["layers"] = (mod.CONFIG.num_layers, (2, 2 + step))
    if mod.FAMILY == "lm" and cell.kind == "train":
        mb = mod.CONFIG.microbatch or cell.global_batch
        n = max(1, cell.global_batch // mb)
        if n > 1:
            out["micro"] = (n, (2, 3))
    return out


def _trace(prog, mesh) -> dict:
    """One trace of ``prog`` on ``mesh``: `jaxpr_cost.analyze`'s counts and
    the collectives' per-kind bytes and calls, as numbers."""
    args = distribute(mesh, prog.args, prog.in_specs)
    r = jaxpr_cost.analyze(prog.fn, *args)
    coll = costs.collective_bytes(r["collectives"])
    mem = dict(r["memory"])
    flat = {"flops": r["flops"], "bytes": r["bytes"],
            **{f"peak:{k}": v for k, v in mem.pop("phase_peaks").items()}, **mem}
    for k in costs.COLLECTIVES:
        flat[f"coll:{k}"] = coll[k]
        flat[f"count:{k}"] = coll["counts"][k]
    return {"values": flat, "kernel_ops": r["kernel_ops"]}


def _affine(samples: dict, points: dict) -> tuple[dict, dict]:
    """Values at the full loop counts, and each value's parts by depth,
    from the traces at the sample points (affine in the layers L, the
    microbatches n and L n). ``samples`` maps (L, n) -> values."""
    (lf, (l1, l2)) = points["layers"]
    nf, (n1, n2) = points.get("micro", (None, (None, None)))
    full, depth = {}, {}
    for key in samples[(l1, n1)]:
        v = {p: Fraction(s[key]) for p, s in samples.items()}
        if n1 is None:
            b = (v[(l2, None)] - v[(l1, None)]) / (l2 - l1)
            a = v[(l1, None)] - b * l1
            parts = (a, b * lf)
        else:
            d = (v[(l2, n2)] - v[(l2, n1)] - v[(l1, n2)] + v[(l1, n1)]) / ((l2 - l1) * (n2 - n1))
            c = (v[(l1, n2)] - v[(l1, n1)]) / (n2 - n1) - d * l1
            b = (v[(l2, n1)] - v[(l1, n1)]) / (l2 - l1) - d * n1
            a = v[(l1, n1)] - b * l1 - c * n1 - d * l1 * n1
            parts = (a + b * lf, c * nf, d * lf * nf)
        total = sum(parts)
        if total.denominator != 1:
            raise ArithmeticError(f"{key}: {total} is not a whole count")
        full[key] = int(total)
        depth[key] = [int(round(p)) for p in parts]
    return full, depth


def _measure(arch_id, shape_name, multi_pod, opt, mesh, unrolled) -> dict:
    points = {} if unrolled else trace_points(arch_id, shape_name)
    if not points:
        prog = build_program(arch_id, shape_name, multi_pod=multi_pod, opt=opt)
        t = _trace(prog, mesh)
        n_coll = {k: t["values"][f"coll:{k}"] for k in costs.COLLECTIVES}
        return {"values": t["values"], "by_depth": {"0": sum(n_coll.values())},
                "kernel_ops": t["kernel_ops"], "traced_at": None}
    ls = points["layers"][1]
    ns = points.get("micro", (None, (None,)))[1]
    samples, kernel_ops = {}, {}
    for l_ in ls:
        for n_ in ns:
            prog = build_program(arch_id, shape_name, multi_pod=multi_pod, opt=opt,
                                 num_layers=l_, n_micro=n_)
            t = _trace(prog, mesh)
            samples[(l_, n_)] = t["values"]
            for k, c in t["kernel_ops"].items():
                kernel_ops[k] = kernel_ops.get(k, 0) + c
    full, depth = _affine(samples, points)
    # the peak is the largest phase's, each phase extrapolated on its own
    full["peak_bytes"] = max(v for k, v in full.items() if k.startswith("peak:"))
    full["temp_bytes"] = full["peak_bytes"] - full["argument_bytes"]
    parts = len(next(iter(depth.values())))
    by_depth = {str(i): sum(depth[f"coll:{k}"][i] for k in costs.COLLECTIVES)
                for i in range(parts)}
    traced_at = {name: list(p[1]) for name, p in points.items()}
    return {"values": full, "by_depth": by_depth, "kernel_ops": kernel_ops,
            "traced_at": traced_at}


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool, opt: bool = False,
             mesh=None, unrolled: bool = False) -> dict:
    """Trace one cell and return its row. ``mesh`` replaces the production
    mesh (its own process group; the row's mesh name then gives its
    shape); ``unrolled`` traces the whole step once, the reference the
    extrapolation is tested against."""
    prog = build_program(arch_id, shape_name, multi_pod=multi_pod, opt=opt)
    t0 = time.time()
    if mesh is None:
        with make_production_mesh(multi_pod=multi_pod) as m:
            chips = m.size()
            res = _measure(arch_id, shape_name, multi_pod, opt, m, unrolled)
        mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    else:
        chips = mesh.size()
        res = _measure(arch_id, shape_name, multi_pod, opt, mesh, unrolled)
        mesh_name = "x".join(str(s) for s in mesh.shape)
    trace_s = time.time() - t0
    v = res["values"]
    coll = {k: v[f"coll:{k}"] for k in costs.COLLECTIVES}
    coll["total"] = sum(coll.values())
    flops, nbytes = v["flops"], v["bytes"]
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "variant": "opt" if opt else "baseline",
        "chips": chips,
        "ok": True,
        "trace_s": round(trace_s, 2),
        "memory": {k: v[k] for k in ("temp_bytes", "argument_bytes", "output_bytes",
                                     "alias_bytes", "peak_bytes")},
        "hlo_flops": flops,
        "hlo_bytes_accessed": nbytes,
        "collective_bytes": coll,
        "collective_counts": {k: v[f"count:{k}"] for k in costs.COLLECTIVES},
        "collective_by_depth": res["by_depth"],
        "loop_trips": list(prog.loop_trips),
        "traced_at": res["traced_at"],
        "kernel_ops": res["kernel_ops"],
        "model_flops": prog.model_flops,
        "useful_flops_ratio": (prog.model_flops / flops) if flops else None,
        "roofline": costs.roofline_terms(flops, nbytes, coll["total"], chips),
        "note": prog.note,
    }


def load_results(path: str = RESULTS) -> list:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def save_results(rows: list, path: str = RESULTS) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def key_of(row) -> tuple:
    return (row["arch"], row["shape"], row["mesh"], row.get("variant", "baseline"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="build the optimised variant of the cell")
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    todo = []
    if args.all:
        for arch_id in ARCH_IDS:
            if arch_id == "fopo-paper":
                continue
            for shape_name in get_arch(arch_id).SHAPES:
                todo.extend((arch_id, shape_name, mp) for mp in meshes)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo.extend((args.arch, args.shape, mp) for mp in meshes)

    variant = "opt" if args.opt else "baseline"
    rows = load_results(args.results)
    done = {key_of(r) for r in rows if r.get("ok") or r.get("skipped")}
    failed = 0
    for arch_id, shape_name, mp in todo:
        mesh_name = "multipod_2x16x16" if mp else "pod_16x16"
        k = (arch_id, shape_name, mesh_name, variant)
        if k in done and not args.force:
            print(f"[skip-cached] {k}")
            continue
        rows = [r for r in rows if key_of(r) != k]
        reason = get_arch(arch_id).SKIPPED_SHAPES.get(shape_name)
        if reason:
            print(f"[skipped] {k}: {reason}")
            rows.append({"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                         "variant": variant, "skipped": True, "reason": reason})
            save_results(rows, args.results)
            continue
        print(f"[run] {k} ...", flush=True)
        try:
            res = run_cell(arch_id, shape_name, multi_pod=mp, opt=args.opt)
            rows.append(res)
            r = res["roofline"]
            print(f"  ok: trace {res['trace_s']}s | peak "
                  f"{res['memory']['peak_bytes'] / 1e9:.2f} GB/device | compute "
                  f"{r['compute_s']:.2e}s mem {r['memory_s']:.2e}s coll "
                  f"{r['collective_s']:.2e}s -> {r['dominant']}", flush=True)
        except Exception as e:  # noqa: BLE001 - recorded as failed; the sweep goes on
            failed += 1
            print(f"  FAILED: {type(e).__name__}: {str(e)[:400]}", flush=True)
            if args.verbose:
                traceback.print_exc()
            rows.append({"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                         "variant": variant, "ok": False,
                         "error": f"{type(e).__name__}: {str(e)[:2000]}"})
        save_results(rows, args.results)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
