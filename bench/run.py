"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. It exits non-zero, and prints no result, without CUDA or with too
few cards, or if `jax`, `jaxlib`, `flax` or the JAX package `repro` is
loaded once the window has closed. Each compared number is printed
beside its limit, last on standard error and under ``checks`` in the
result. Build caches stay inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
PIN_CORES = 2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process on the chip, on few cores: pinned to the last PIN_CORES
    # of those it may use, its host work no longer migrates between cores
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > PIN_CORES:
        os.sched_setaffinity(0, cores[-PIN_CORES:])
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
        sys.path.pop(0)  # bench/ itself, where the script lies
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness

    bm = harness.load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bm["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
