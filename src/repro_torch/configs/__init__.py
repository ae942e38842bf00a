"""Architecture registry of the port: --arch <id> resolves here.

The ids are the reference's, every one of them ported, and the port's
own "trinity-mini" (reachable by `get_arch`, outside `ARCH_IDS` and
`all_cells`, which stay the reference's). Each config
module exports FAMILY, CONFIG, SHAPES, SKIPPED_SHAPES and SMOKE_CONFIG;
an unknown id raises KeyError.
"""
from __future__ import annotations

import importlib
import types

ARCH_IDS = [
    # LM family (5)
    "mistral-large-123b",
    "granite-8b",
    "gemma2-2b",
    "olmoe-1b-7b",
    "arctic-480b",
    # GNN (1)
    "graphcast",
    # recsys (4)
    "dien",
    "sasrec",
    "wide-deep",
    "din",
    # the paper's own experiment
    "fopo-paper",
]

PORTED = {
    "sasrec": "sasrec",
    "fopo-paper": "fopo_paper",
    "mistral-large-123b": "mistral_large_123b",
    "granite-8b": "granite_8b",
    "gemma2-2b": "gemma2_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "arctic-480b": "arctic_480b",
    "graphcast": "graphcast",
    "din": "din",
    "dien": "dien",
    "wide-deep": "wide_deep",
    # the port's own: no reference counterpart, so not in ARCH_IDS
    "trinity-mini": "trinity_mini",
}


def get_arch(arch_id: str) -> types.ModuleType:
    if arch_id not in PORTED:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch_id]}")


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, cell, skipped_reason or None) for the
    assigned pool (40 cells, fopo-paper not among them), in the
    reference's order. Like the reference's, every cell is yielded, the
    skipped ones with their reason, whatever ``include_skipped`` says."""
    del include_skipped  # the reference's signature; it filters nothing
    for arch_id in ARCH_IDS:
        if arch_id == "fopo-paper":
            continue
        mod = get_arch(arch_id)
        for shape_name, cell in mod.SHAPES.items():
            yield arch_id, shape_name, cell, mod.SKIPPED_SHAPES.get(shape_name)
