"""What the benchmark loads and reads: nothing of JAX or of the JAX
package `repro` (top-level names compared whole: `repro_torch` is the
port), the references nothing of the program, and nothing under
`benchmarks/` or `results/`."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = harness.ROOT / "bench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if not p.name.startswith("test_"))


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_old_harness(path):
    assert not _imports(path) & set(harness.FORBIDDEN)
    text = path.read_text()
    assert "benchmarks/" not in text and "results/" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert all(m in {"__future__", "bench", "torch", "numpy", "contextlib", "dataclasses",
                     "math", "typing", "warnings"} for m in _imports(path))


def test_a_run_loads_no_forbidden_module():
    """A whole run, in a process of its own, as `bench/run.py` makes it
    (the CPU path at a tiny size), then the names in `sys.modules`."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "import bench.run\n"
        "from bench.tinycells import TINY, tiny_run\n"
        "for w in TINY: tiny_run(w, seed=11)\n"
        "from bench import harness, calibrate\n"
        "print('FORBIDDEN=' + ','.join(harness.forbidden_modules()))\n"
    ).format(root=str(harness.ROOT), src=str(harness.ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN="


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.train", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax", "flax.linen"]) == [
        "flax", "jax", "repro"]


def test_run_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "sasrec.bulk-b4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=120,
                         cwd=str(harness.ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
