"""The port's ground rules, on the CPU.

* `repro_torch` imports neither JAX nor the reference package `repro`,
  at run time (a subprocess imports every module) or in its source
  (`src/repro_torch/**` and `chip_smoke.py` are scanned).
* An entry point asked for CUDA where there is none raises; it never
  falls back to the CPU.
* A CUDA tensor reaches the kernel or an error, never the plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data import SyntheticConfig, generate_sessions  # noqa: E402
from repro_torch.kernels.fused_sampler import ops as sampler_ops  # noqa: E402
from repro_torch.kernels.ivf_topk import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.mips_topk import ops as mips_ops  # noqa: E402
from repro_torch.kernels.snis_covgrad import ops as covgrad_ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train import FOPOTrainer, TrainerConfig  # noqa: E402
from repro_torch.mips import ivf  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.serve import QueryPlanner, RecsysMIPSRoute  # noqa: E402

PKG = Path(repro_torch.__file__).resolve().parent
ROOT = PKG.parents[1]

_IMPORTS_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORTS_ALL], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20  # every module was imported


def test_sources_import_no_jax_and_no_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert (ROOT / "chip_smoke.py").exists()
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_entry_points_refuse_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("sasrec").SMOKE_CONFIG
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()  # the default is "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecsysMIPSRoute(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryPlanner(None, params, params["items"], top_k=4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ivf.build_ivf(params["items"], num_clusters=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "sasrec", "--requests", "1"])


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrapper's CUDA branch raises for what the kernel cannot take
    and does not fall back to the plain version."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    rng = np.random.default_rng(0)
    index = ivf.IVFIndex(
        centroids=torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        lists=torch.arange(32, dtype=torch.int32).reshape(4, 8),
        list_embs=torch.from_numpy(rng.standard_normal((4, 8, 8)).astype(np.float32)),
        num_items=32,
    )
    calls = ref.ivf_probe_topk_ref.calls
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ivf_topk(torch.zeros((2, 8)), index, 3, n_probe=2)
    assert ref.ivf_probe_topk_ref.calls == calls


def _covgrad_args():
    z = torch.zeros((2, 8))
    return torch.zeros((2, 8)), torch.zeros((10, 8)), z.int(), z, z


_WRAPPERS = {
    "mips_topk": (mips_ops, "mips_topk_ref", lambda: mips_ops.mips_topk(
        torch.zeros((2, 8)), torch.zeros((10, 8)), 3)),
    "fused_sampler": (sampler_ops, "fused_sampler_ref", lambda: sampler_ops.fused_mixture_sample(
        0, torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 4)), num_samples=8,
        epsilon=0.5, num_items=10, sample_tile=8)),
    "snis_covgrad_fwd": (covgrad_ops, "snis_fwd_ref", lambda: covgrad_ops.snis_scores_fused(
        *_covgrad_args())),
    "snis_covgrad_bwd": (covgrad_ops, "snis_bwd_ref", lambda: covgrad_ops.snis_covgrad_bwd(
        torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32), torch.zeros((10, 8)))),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_training_kernels_never_take_the_plain_version_on_cuda(monkeypatch, name):
    """The training kernels' wrappers, as `ivf_topk`'s above: a tensor
    taken for CUDA reaches the kernel's wrapper, which raises here, and
    the plain version is not called."""
    mod, plain, call = _WRAPPERS[name]
    monkeypatch.setattr(mod, "_on_cuda", lambda t: True)
    calls = getattr(mod._ref, plain).calls
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert getattr(mod._ref, plain).calls == calls


def test_training_entry_points_refuse_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = generate_sessions(SyntheticConfig(num_items=50, num_users=20, embed_dim=4, session_len=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FOPOTrainer(TrainerConfig(), ds)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "fopo-paper", "--steps", "1"])


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """No nvcc, or a failing nvcc, is an error with the compiler's words,
    never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    src = tmp_path / "k.cu"
    src.write_text("int f(void) { return 0; }\n")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(src)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load(src)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_build_is_cached_by_source_hash(monkeypatch, tmp_path):
    """A library built for a source is reused; an edited source, or a
    header beside it, builds anew."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = _build._target(src)
    first.write_bytes(b"")  # as if built
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt a cached source"))
    assert _build.build([src]) == {src: first}
    src.write_text("// v2\n")
    second = _build._target(src)
    assert second != first
    (tmp_path / "common.cuh").write_text("// a header beside the source\n")
    assert _build._target(src) not in (first, second)


def test_kernel_wrapper_splits_lists_to_fill_the_card():
    """At the serving shape (B=8, n_probe=8, K=10, L 50) each list is cut
    into ranges so the kernel has >= 132 blocks; at K=256 the merge's
    partial lists stay within one staging of its shared memory; a short
    list is one range; a large batch cuts a list only to the 1024 slots
    a block takes."""
    splits, chunk = kernel.splits_for(8, 8, 2048, 10, 50)
    assert 8 * 8 * splits >= 132 and chunk % 32 == 0
    assert (splits - 1) * chunk < 2048 <= splits * chunk
    assert kernel.splits_for(8, 8, 2048, 256, 50) == (5, 416)
    assert kernel.splits_for(8, 8, 8, 10, 50) == (1, 32)
    assert kernel.splits_for(4096, 8, 2048, 10, 50) == (2, 1024)


def test_shared_header_edit_rebuilds_both_topk_kernels(monkeypatch, tmp_path):
    """The retrieval kernels include `kernels/csrc/topk_select.cuh`: an
    edit there changes the library name of both sources (and of every
    other, since each is built with that directory on its include path),
    so no stale library is loaded. A copy of the tree; no nvcc runs."""
    import shutil

    tree = tmp_path / "kernels"
    shutil.copytree(PKG / "kernels", tree, ignore=shutil.ignore_patterns("_build", "*.py*"))
    monkeypatch.setattr(_build, "SHARED_DIR", tree / "csrc")
    sources = [tree / "mips_topk" / "csrc" / "mips_topk.cu",
               tree / "ivf_topk" / "csrc" / "ivf_topk.cu"]
    for src in sources:
        assert '#include "topk_select.cuh"' in src.read_text()
    before = [_build._target(src) for src in sources]
    header = tree / "csrc" / "topk_select.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = [_build._target(src) for src in sources]
    assert all(a != b for a, b in zip(after, before))
    assert [t.name.split("-")[0] for t in after] == ["mips_topk", "ivf_topk"]


def test_flash_attention_never_takes_the_plain_version_on_cuda(monkeypatch):
    """K9's wrapper, as the others: a tensor taken for CUDA reaches the
    kernel's wrapper, which raises here, and the plain version is not
    called."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    monkeypatch.setattr(flash_ops, "_on_cuda", lambda t: True)
    calls = flash_ops._ref.flash_attention_ref.calls
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_ops.flash_attention(torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 1, 16)),
                                  torch.zeros((1, 8, 1, 16)))
    assert flash_ops._ref.flash_attention_ref.calls == calls


def test_flash_backward_never_takes_the_plain_version_on_cuda(monkeypatch):
    """K10's wrapper: the autograd backward of a tensor taken for CUDA
    reaches the backward kernel's wrapper, which raises here; the plain
    backward is not called."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    k = torch.zeros((1, 8, 1, 16), requires_grad=True)
    out = flash_ops.flash_attention(q, k, k)  # the forward on the CPU
    monkeypatch.setattr(flash_ops, "_on_cuda", lambda t: True)
    calls = flash_ops._ref.flash_attention_bwd_ref.calls
    with pytest.raises(ValueError, match="CUDA tensors"):
        out.sum().backward()
    assert flash_ops._ref.flash_attention_bwd_ref.calls == calls


def test_lm_entry_points_refuse_cuda_without_cuda(monkeypatch):
    from repro_torch.models import lm
    from repro_torch.serve import LMGenerateRoute

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("gemma2-2b").SMOKE_CONFIG
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMGenerateRoute(cfg, params, prompt_len=4, gen_len=2, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "gemma2-2b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "gemma2-2b", "--steps", "1"])


@pytest.mark.parametrize(
    "arch", ["gemma2-2b", "mistral-large-123b", "granite-8b", "olmoe-1b-7b", "arctic-480b"]
)
def test_lm_archs_resolve_only_when_ported(arch):
    """Every LM arch is ported: each resolves to the port's config module,
    whose CONFIG and SMOKE_CONFIG are the reference's, field for field."""
    import dataclasses

    from repro.configs import get_arch as jax_get_arch

    mod = get_arch(arch)
    assert mod.FAMILY == "lm" and mod.CONFIG.name == arch
    assert mod.__name__ == f"repro_torch.configs.{arch.replace('-', '_')}"
    ref = jax_get_arch(arch)
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(mod, name)) == dataclasses.asdict(getattr(ref, name))


def test_planner_probe_waits_for_the_health_slice():
    """The health slice has landed: the planner takes ``probe_x`` /
    ``probe_k`` and probes on the CPU (without a probe set it reports
    None, and the ladder watches overflow only)."""
    cfg = get_arch("sasrec").SMOKE_CONFIG
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    route = RecsysMIPSRoute(cfg, params, k=4, device="cpu")
    assert route.probe() is None and route.overflow() == 0
    hists = np.random.default_rng(0).integers(-1, cfg.item_vocab, (4, cfg.seq_len))
    planner = QueryPlanner(route.planner.policy, params, params["items"], top_k=4,
                           device="cpu", probe_x=torch.from_numpy(hists), probe_k=8)
    assert planner.probe_k == 8 and 0.0 <= planner.probe() <= 1.0


def test_embedding_bag_never_takes_the_plain_version_on_cuda(monkeypatch):
    """K8's wrapper, as the others: sum and mean of a table taken for CUDA
    reach the kernel's wrapper, which raises here, and the plain version
    is not called."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    monkeypatch.setattr(eb_ops, "_on_cuda", lambda t: True)
    calls = eb_ops._ref.embedding_bag_ref.calls
    for combiner in ("sum", "mean"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            eb_ops.embedding_bag(torch.zeros((10, 8)), torch.zeros((2, 3), dtype=torch.int32),
                                 combiner)
    assert eb_ops._ref.embedding_bag_ref.calls == calls


@pytest.mark.parametrize("arch,module", [("din", "din"), ("dien", "dien"),
                                         ("wide-deep", "wide_deep")])
def test_recsys_archs_resolve_to_the_port(arch, module):
    mod = get_arch(arch)
    assert mod.__name__ == f"repro_torch.configs.{module}"
    assert mod.FAMILY == "recsys" and mod.CONFIG.name == arch


@pytest.mark.parametrize("arch", ["din", "dien", "wide-deep"])
def test_recsys_entry_points_refuse_cuda_without_cuda(monkeypatch, arch):
    from repro_torch.serve import DenseCandidateRoute

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch(arch).SMOKE_CONFIG
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if arch == "dien":
            RecsysMIPSRoute(cfg, params)
        else:
            DenseCandidateRoute(cfg, params, candidates=np.arange(10))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", arch, "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", arch, "--steps", "1"])


@pytest.mark.parametrize("arch", ["sasrec", "olmoe-1b-7b", "arctic-480b", "granite-8b",
                                  "mistral-large-123b", "graphcast"])
def test_models_slice_entry_points_refuse_cuda_without_cuda(monkeypatch, arch):
    """The arches the models slice brings to training (and the LM ones to
    serving) ask for CUDA by default and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", arch, "--steps", "1"])
    if arch not in ("sasrec", "graphcast"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--arch", arch, "--requests", "1"])


_IMPORTS_SLICE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
"""


@pytest.mark.parametrize("modules", [
    ("repro_torch.embeddings", "repro_torch.embeddings.bag", "repro_torch.embeddings.table"),
    ("repro_torch.kernels.embedding_bag.ops", "repro_torch.kernels.embedding_bag.kernel",
     "repro_torch.kernels.embedding_bag.ref"),
    ("repro_torch.configs.din", "repro_torch.configs.dien", "repro_torch.configs.wide_deep",
     "repro_torch.models.recsys", "repro_torch.serve.routes", "repro_torch.convert"),
    ("repro_torch.mips.refresh", "repro_torch.health", "repro_torch.health.guard",
     "repro_torch.health.faults", "repro_torch.health.index_health",
     "repro_torch.train.checkpoint", "repro_torch.train.trainer", "repro_torch.serve.planner",
     "repro_torch.serve.engine", "repro_torch.launch.serve"),
    ("repro_torch.obs", "repro_torch.obs.drift", "repro_torch.obs.report",
     "repro_torch.obs.run", "repro_torch.obs.sinks", "repro_torch.obs.trace",
     "repro_torch.serve.cluster", "repro_torch.serve"),
    ("repro_torch.dist", "repro_torch.dist.collectives", "repro_torch.dist.fopo",
     "repro_torch.mips.sharded", "repro_torch.core.plan", "repro_torch.train.trainer"),
    ("repro_torch.models.moe", "repro_torch.models.lm", "repro_torch.core.lm_head",
     "repro_torch.core", "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.arctic_480b",
     "repro_torch.configs.granite_8b", "repro_torch.configs.mistral_large_123b",
     "repro_torch.launch.train"),
    ("repro_torch.models.gnn", "repro_torch.data.graph_sampling", "repro_torch.optim.compression",
     "repro_torch.launch.costs", "repro_torch.configs.graphcast"),
], ids=["embeddings", "embedding_bag", "recsys", "health", "obs_cluster", "dist", "models",
        "models_gnn"])
def test_embedding_slice_modules_import_no_jax(modules):
    """This slice's modules, each set alone in a fresh interpreter."""
    res = subprocess.run(
        [sys.executable, "-c", _IMPORTS_SLICE, *modules], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)}, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_unported_arch_names_the_models_item(capsys):
    """Every arch is ported since the models slice (ROADMAP Queue A item
    6) finished with the GNN: graphcast resolves, trains on the CPU
    through the train CLI, and the serve CLI refuses it as the reference
    does ("has no serving path"); an unknown id is still a KeyError."""
    mod = get_arch("graphcast")
    assert mod.FAMILY == "gnn" and mod.CONFIG.num_layers == 16
    train_cli.main(["--arch", "graphcast", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.findall(r"^step (\d): loss=[0-9.]+$", out, re.M) == ["0", "1"]
    with pytest.raises(SystemExit, match=r"^graphcast \(gnn\) has no serving path$"):
        serve_cli.main(["--arch", "graphcast", "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("graphcast-2")


def test_serve_cli_cluster_chaos_with_obs_dir_answers_every_request(tmp_path, capsys):
    """``--replicas 3 --chaos --obs-dir`` on the CPU: replica 1 dies at its
    first dispatch, every request is answered by the survivors, and the
    run directory renders a report with Serving and Cluster sections."""
    from repro_torch.obs.report import render_run

    run_dir = str(tmp_path / "run")
    serve_cli.main(["--arch", "sasrec", "--device", "cpu", "--requests", "24",
                    "--replicas", "3", "--chaos", "--obs-dir", run_dir])
    out = capsys.readouterr().out
    assert "24 answered / 0 unanswered" in out and "deaths 1" in out
    assert "r1:0 (dead)" in out and f"obs artifacts in {run_dir}" in out
    text = open(render_run(run_dir)).read()
    assert "## Serving" in text and "## Cluster" in text
    assert "| serve_replica_deaths | 1 |" in text
    with pytest.raises(SystemExit, match="--chaos needs --replicas >= 2"):
        serve_cli.main(["--arch", "sasrec", "--device", "cpu", "--chaos"])


_IMPORTS_DRY_RUN = """
import sys
import torch.distributed as dist
import repro_torch.dist.sharding, repro_torch.launch.mesh, repro_torch.launch.specs
import repro_torch.launch.jaxpr_cost, repro_torch.launch.dryrun
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert not dist.is_initialized(), "a process group was made at import"
print("ok")
"""


def test_dry_run_modules_import_no_jax_and_make_no_process_group():
    res = subprocess.run([sys.executable, "-c", _IMPORTS_DRY_RUN], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(PKG.parent)},
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_reference_modules_without_a_port_file_are_the_shims_and_the_cu_sources():
    """Every reference module has a file at the same path in the port but
    the three JAX shims and the two kernels' backward.py files, whose
    kernels are the `.cu` sources beside their `kernel.py`."""
    ref = ROOT / "src" / "repro"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (PKG / p.relative_to(ref)).exists())
    assert missing == ["backend.py", "compat.py", "kernels/_compat.py",
                       "kernels/flash_attention/backward.py",
                       "kernels/snis_covgrad/backward.py"]
    assert (PKG / "kernels/flash_attention/csrc/flash_attention_bwd.cu").exists()
    assert (PKG / "kernels/snis_covgrad/csrc/snis_covgrad_bwd.cu").exists()

