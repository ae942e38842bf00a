"""Build the hand-written CUDA kernels and load them with ctypes.

Each kernel is one `.cu` file under its package's `csrc/`, with a plain C
interface (no PyTorch headers, so `nvcc` takes seconds); sources of one
package may share `.cuh` headers beside them. It is compiled for Hopper
(`sm_90a`) at first use into ``BUILD_DIR``, one shared library per
source, named by the hash of the source and of the headers in its
directory: an edited source or header builds anew, an unchanged one is
loaded from the cache. `build` starts one `nvcc`
per source, all at once, and waits for them all.

Nothing here runs when a module is imported: the CPU tests import every
module of the port on a machine that has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are built from source at first use"
    )


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[Path]) -> dict[Path, Path]:
    """Compile every source whose library is not cached yet, one `nvcc`
    per source, all started together. Returns {source: library path}.
    Raises RuntimeError with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {Path(s): _target(Path(s)) for s in sources}
    jobs = []
    for src, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent reader sees all or nothing
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]))
        _LOADED[source] = lib
    return lib
