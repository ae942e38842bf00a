"""The readings that the correctness limits of a cell are set from, on
the card at the cell's own size; the benchmark's runs never run this:

    python3 bench/calibrate.py --workload <cell> --seeds <n,n,...> \
        [--control-seeds <n,...>] [--seconds <s>]

For each seed the cell's driver (its `Run.calibration`) reads the
program's numbers after a short window at the cell's load; for each
control seed also the control, the reference put in the program's place
and computed in TF32, the precision below the configuration's fp32, and
the faults the driver plants in the reference put there. One JSON line
a seed goes to standard output and to
``chiprun_out/calibrate/<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, control: bool, seconds: float, device) -> dict:
    """One seed's readings: the cell's driver reads them itself."""
    import torch

    run = cell.driver.Run(cell.config, cell.traffic, seed, device)
    line = {"seed": seed, **run.calibration(control, seconds)}
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("calibrate reads the card: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell.find(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(control)
    out = ROOT / "chiprun_out" / "calibrate"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{args.workload}.jsonl", "a") as f:
        for seed in dict.fromkeys(seeds):
            t0 = time.perf_counter()
            line = readings(cell, seed, seed in control, args.seconds, torch.device("cuda"))
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
