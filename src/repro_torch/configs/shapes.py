"""Canonical shape cells per architecture family (the reference's
`repro/configs/shapes.py`); the LM family's for now."""
from __future__ import annotations

from repro_torch.models.configs_base import ShapeCell

LM_SHAPES = {
    "train_4k": ShapeCell(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeCell(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeCell(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeCell(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
}
