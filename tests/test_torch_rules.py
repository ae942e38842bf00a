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
from repro_torch.kernels.ivf_topk import kernel, ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
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
    """A library built for a source is reused; an edited source builds anew."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = _build._target(src)
    first.write_bytes(b"")  # as if built
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt a cached source"))
    assert _build.build([src]) == {src: first}
    src.write_text("// v2\n")
    assert _build._target(src) != first


def test_kernel_wrapper_splits_lists_to_fill_the_card():
    """At the serving shape (B=8, n_probe=8, K=10) each list is cut into
    chunks so the probe kernel has >= 132 blocks; at K=256 the merge's
    candidate count keeps lists whole; a short list is one chunk."""
    splits, chunk = kernel.splits_for(8, 8, 2048, 10, 128)
    assert 8 * 8 * splits >= 132 and chunk % 128 == 0
    assert (splits - 1) * chunk < 2048 <= splits * chunk
    assert kernel.splits_for(8, 8, 2048, 256, 128) == (1, 2048)
    assert kernel.splits_for(8, 8, 8, 10, 128) == (1, 128)
    assert kernel.splits_for(4096, 8, 2048, 10, 128) == (1, 2048)
