"""Each cell shrunk to a size the CPU tests can run through the whole
harness in seconds, with the program's CPU path (the kernels' plain
versions) under it. Widths are cut here, in the tests only.

A cell's tiny size is `bench/tiny/<cell>.json`, ``{"config": {...},
"traffic": {...}}``: the keys it overrides in the cell's configuration
and traffic. `TINY` holds them, as (config, traffic), for every workload
of `BENCHMARK.json` that has the file (the contract tests ask each to)."""
from __future__ import annotations

import dataclasses

import torch

from bench import harness

TINY_DIR = harness.BENCH / "tiny"


def _tiny(workload: str) -> tuple[dict, dict]:
    sizes = harness.load_json(TINY_DIR / f"{workload}.json")
    return sizes["config"], sizes["traffic"]


TINY = {w["name"]: _tiny(w["name"])
        for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
        if (TINY_DIR / f"{w['name']}.json").is_file()}


def tiny_cell(workload: str) -> harness.Cell:
    """The cell with its configuration and traffic cut to the tiny size."""
    cell = harness.Cell.find(workload)
    cfg, traffic = TINY[workload]
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **traffic})


def tiny_run(workload: str, seed: int, trace: bool = False, seconds: float = 0.4):
    """One whole run of the harness at the tiny size on the CPU."""
    cfg, traffic = TINY[workload]
    return harness.run_cell(workload, seed, seconds, trace, device="cpu",
                            config_overrides=cfg, traffic_overrides=traffic)


def tiny_driver(workload: str, seed: int):
    """The cell's driver set up at the tiny size on the CPU."""
    cell = tiny_cell(workload)
    return cell.driver.Run(cell.config, cell.traffic, seed, torch.device("cpu"))
