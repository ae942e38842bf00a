"""The dry run (`repro_torch.launch.dryrun`), on the CPU: the collectives
one rank issues for hand-derived programs on a 2 x 2 fake mesh, `run_cell`
on cheap production cells on the 256-rank pod mesh, the sweep's records
(a failing cell recorded as failed while the sweep goes on, rows
resumed), no process group left behind, and an LM training step traced
at two sizes of its loops against the unrolled trace.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.launch import costs, dryrun, jaxpr_cost, specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402

B, D, F = 8, 16, 32


def _mlp_args(mesh):
    """x [B, D] sharded over data; w1 [D, F] column-parallel, w2 [F, D]
    row-parallel over model."""
    return specs.distribute(
        mesh,
        (torch.empty(B, D, device="meta"),
         {"w1": torch.empty(D, F, device="meta"), "w2": torch.empty(F, D, device="meta")}),
        (("data", None), {"w1": (None, "model"), "w2": ("model", None)}),
    )


def _mlp(x, p):
    return torch.relu(x @ p["w1"]) @ p["w2"]


def test_column_then_row_parallel_mlp_collectives():
    from torch.distributed.tensor import Replicate

    with make_debug_mesh(2, 2) as mesh:
        x, p = _mlp_args(mesh)
        # forward: y is a partial sum over model and sharded over data;
        # replicating it is an all-reduce of rank 0's [B/2, D] over model
        # and an all-gather of [B, D] over data
        r = jaxpr_cost.analyze(
            lambda x_, p_: _mlp(x_, p_).redistribute(mesh, [Replicate(), Replicate()]), x, p)
        got = costs.collective_bytes(r["collectives"])
        assert got["all-reduce"] == B // 2 * D * 4 and got["counts"]["all-reduce"] == 1
        assert got["all-gather"] == B * D * 4 and got["counts"]["all-gather"] == 1
        assert got["total"] == B // 2 * D * 4 + B * D * 4
        assert r["product_flops"] == 2 * B * D * F + 2 * B * F * D  # global, once
        # forward and backward: each weight's gradient is a partial sum over
        # data (each data rank saw its rows), reduced to the weight's layout
        # at once: one all-reduce of its [D, F/2] / [F/2, D] shard each
        r = jaxpr_cost.analyze(lambda x_, p_: value_and_grad(lambda q: _mlp(x_, q).sum(), p_),
                               x, p)
        got = costs.collective_bytes(r["collectives"])
        assert got["counts"] == {"all-reduce": 2, "all-gather": 0, "reduce-scatter": 0,
                                 "all-to-all": 0, "collective-permute": 0}
        assert got["all-reduce"] == 2 * D * F // 2 * 4
        grads = r["out"][1]
        assert grads["w1"].placements == p["w1"].placements
        assert grads["w2"].placements == p["w2"].placements
        # two products forward; backward dh, dW2 and dW1 (x needs none)
        assert r["product_flops"] == 5 * (2 * B * D * F)
    assert not dist.is_initialized()


def test_memory_of_a_rank():
    """One rank's local bytes: arguments, then the two products' outputs."""
    with make_debug_mesh(2, 2) as mesh:
        x, p = _mlp_args(mesh)
        r = jaxpr_cost.analyze(lambda x_, p_: x_ @ p_["w1"], x, p)
        mem = r["memory"]
        args = (B // 2 * D + D * F // 2 + F // 2 * D) * 4
        assert mem["argument_bytes"] == args
        assert mem["output_bytes"] == B // 2 * F // 2 * 4
        assert mem["peak_bytes"] == args + mem["output_bytes"]
        assert mem["alias_bytes"] == 0


REF_KEYS = {"arch", "shape", "mesh", "variant", "chips", "ok", "memory", "hlo_flops",
            "hlo_bytes_accessed", "collective_bytes", "collective_counts",
            "collective_by_depth", "loop_trips", "model_flops", "useful_flops_ratio",
            "roofline", "note"}


@pytest.mark.parametrize("arch,shape", [("graphcast", "molecule"),
                                        ("wide-deep", "retrieval_cand")])
def test_run_cell_on_the_pod_mesh(arch, shape):
    row = dryrun.run_cell(arch, shape, multi_pod=False)
    assert not dist.is_initialized()
    # the reference's keys, trace_s for lower_s / compile_s, and the port's own
    assert set(row) == REF_KEYS | {"trace_s", "traced_at", "kernel_ops"}
    assert row["ok"] and row["chips"] == 256 and row["mesh"] == "pod_16x16"
    assert row["hlo_flops"] > 0 and row["hlo_bytes_accessed"] > 0
    mem = row["memory"]
    assert set(mem) == {"temp_bytes", "argument_bytes", "output_bytes", "alias_bytes",
                        "peak_bytes"}
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert row["collective_bytes"]["total"] == sum(
        row["collective_bytes"][k] for k in costs.COLLECTIVES)
    assert sum(row["collective_by_depth"].values()) == row["collective_bytes"]["total"]
    assert row["roofline"] == costs.roofline_terms(
        row["hlo_flops"], row["hlo_bytes_accessed"], row["collective_bytes"]["total"], 256)
    assert row["useful_flops_ratio"] == row["model_flops"] / row["hlo_flops"]
    if arch == "graphcast":  # its layer loop is traced at 2 and 3 layers
        assert row["traced_at"] == {"layers": [2, 3]}
        assert row["collective_bytes"]["total"] > 0


def test_sweep_records_failures_and_resumes(tmp_path, monkeypatch, capsys):
    path = tmp_path / "dryrun_torch.json"
    real = dryrun.run_cell

    def run_cell(arch, shape, *, multi_pod, **kw):
        if multi_pod:
            raise RuntimeError("no sharding strategy for aten.example")
        return real(arch, shape, multi_pod=multi_pod, **kw)

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    argv = ["--arch", "din", "--shape", "serve_p99", "--mesh", "both",
            "--results", str(path)]
    assert dryrun.main(argv) == 1  # a cell failed; the other still ran
    rows = json.loads(path.read_text())
    assert [(r["mesh"], r["ok"]) for r in rows] == [("pod_16x16", True),
                                                     ("multipod_2x16x16", False)]
    assert "aten.example" in rows[1]["error"]
    assert not dist.is_initialized()
    # resumed: the ok row is kept, the failed one runs again
    monkeypatch.setattr(dryrun, "run_cell", real)
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "[skip-cached] ('din', 'serve_p99', 'pod_16x16', 'baseline')" in out
    rows = json.loads(path.read_text())
    assert [(r["mesh"], r["ok"], r["chips"]) for r in rows] == [
        ("pod_16x16", True, 256), ("multipod_2x16x16", True, 512)]
    # a skipped cell is written as the reference writes it
    assert dryrun.main(["--arch", "granite-8b", "--shape", "long_500k",
                        "--results", str(path)]) == 0
    last = json.loads(path.read_text())[-1]
    assert last["skipped"] and "full-attention" in last["reason"]


def test_no_process_group_is_left_behind():
    with pytest.raises(ZeroDivisionError):
        with make_production_mesh(multi_pod=True) as mesh:
            assert mesh.size() == 512 and dist.get_world_size() == 512
            raise ZeroDivisionError
    assert not dist.is_initialized()
    with make_debug_mesh(1, 1):
        with pytest.raises(RuntimeError, match="already exists"):
            with make_debug_mesh(1, 1):
                pass
    assert not dist.is_initialized()


def test_lm_train_extrapolated_trace_equals_unrolled(monkeypatch):
    """Granite at SMOKE widths, 4 layers x 4 microbatches of 4 rows, against its
    trace at 2-3 layers x 2-3 microbatches (the microbatch and layer loops
    of `lm.make_train_step`)."""
    from test_torch_common import small_cell

    small_cell(monkeypatch, "granite-8b", "train_4k", num_layers=4, microbatch=4)
    pts = dryrun.trace_points("granite-8b", "train_4k")
    assert pts == {"layers": (4, (2, 3)), "micro": (4, (2, 3))}
    with make_debug_mesh(2, 2) as mesh:
        scaled = dryrun.run_cell("granite-8b", "train_4k", multi_pod=False, mesh=mesh)
        unrolled = dryrun.run_cell("granite-8b", "train_4k", multi_pod=False, mesh=mesh,
                                   unrolled=True)
    for key in ("hlo_flops", "hlo_bytes_accessed", "collective_bytes", "collective_counts"):
        assert scaled[key] == unrolled[key], key
    assert scaled["memory"]["argument_bytes"] == unrolled["memory"]["argument_bytes"]
    assert scaled["memory"]["peak_bytes"] == pytest.approx(unrolled["memory"]["peak_bytes"],
                                                           rel=0.02)
    assert len(scaled["collective_by_depth"]) == 3
