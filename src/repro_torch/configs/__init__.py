"""Architecture registry of the port: --arch <id> resolves here.

The ids are the reference's. An arch that is not ported yet raises
NotImplementedError naming it; an unknown id raises KeyError.
"""
from __future__ import annotations

import importlib
import types

ARCH_IDS = [
    "mistral-large-123b",
    "granite-8b",
    "gemma2-2b",
    "olmoe-1b-7b",
    "arctic-480b",
    "graphcast",
    "dien",
    "sasrec",
    "wide-deep",
    "din",
    "fopo-paper",
]

PORTED = {
    "sasrec": "sasrec",
    "fopo-paper": "fopo_paper",
    "gemma2-2b": "gemma2_2b",
    "din": "din",
    "dien": "dien",
    "wide-deep": "wide_deep",
}


def get_arch(arch_id: str) -> types.ModuleType:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(PORTED)}); it comes with the models slice (ROADMAP Queue A "
            "item 6)"
        )
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch_id]}")
