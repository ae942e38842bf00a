"""Each cell shrunk to a size the CPU tests can run through the whole
harness in seconds, with the program's CPU path (the kernels' plain
versions) under it. Widths are cut here, in the tests only."""
from __future__ import annotations

import dataclasses

import torch

from bench import harness

TINY = {
    "fopo-paper.exact-b4096": (
        {"num_items": 3000, "embed_dim": 16, "num_samples": 64, "top_k": 32, "num_users": 512},
        {"batch": 64, "catalog_clusters": 32, "positives_from_top": 16, "steps_per_call": 3,
         "trace_seconds": 0.3},
    ),
    "sasrec.bulk-b4096": (
        {"item_vocab": 5000, "embed_dim": 16, "seq_len": 12, "num_clusters": 64, "n_probe": 4},
        {"batch": 64, "users": 1024, "judge_every": 2, "warm_batches": 1, "ahead": 3,
         "trace_seconds": 0.3},
    ),
}


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
