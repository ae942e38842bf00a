"""The Hopper EmbeddingBag kernel (`csrc/embedding_bag.cu`), bound with
ctypes.

`embedding_bag_cuda` computes what the reference's `embedding_bag_pallas`
computes: per bag, the live rows (id >= 0) of the table added in t order
in the table's dtype (fp32 or bf16), an id >= V reading row V - 1. See
the source for the design and its bound.

The wrapper checks device, dtype, shape and contiguity, picks the
kernel's word path (4 elements a lane) when D is a multiple of 4 and the
table's start is aligned to such a word, allocates the output with
`torch.empty`, launches on PyTorch's current stream without
synchronising, and raises if the launch is refused. It counts its
launches in ``embedding_bag_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["SOURCE", "embedding_bag_cuda", "embedding_bag_work", "library", "vec_width"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "embedding_bag_launch", "ppp" + "i" * 6 + "p")
    _launch.declare(lib, "embedding_bag_error_string", "i", ctypes.c_char_p)
    return lib


def vec_width(table: torch.Tensor) -> int:
    """Elements a lane reads as one word: 4 (16 bytes of fp32, 8 of bf16)
    when D is a multiple of 4 and the table starts on such a word, else 1
    (the scalar path)."""
    d = table.shape[1]
    word = 4 * table.element_size()
    return 4 if d % 4 == 0 and table.data_ptr() % word == 0 else 1


def embedding_bag_work(b: int, t: int, v: int, d: int, itemsize: int,
                       rows: int | None = None,
                       live: int | None = None) -> tuple[int, int, int]:
    """(adds, 1, bytes) of one sum over [B, T] bags of a [V, D] table:
    each distinct live row read once (``rows``; an id >= V reads row
    V - 1), the ids read, the [B, D] output written; one add an element
    of each of the ``live`` ids' rows. By default every id is live and
    distinct: B T ids, min(B T, V) rows."""
    live = b * t if live is None else live
    rows = min(b * t, v) if rows is None else rows
    return live * d, 1, rows * d * itemsize + b * t * 4 + b * d * itemsize


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table [V, D] fp32 or bf16, indices [B, T] int32 (-1 padded) ->
    out [B, D] in the table's dtype, on the card."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_cuda takes CUDA tensors, got {dev}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"table has dtype {table.dtype}, expected float32 or bfloat16")
    _launch.check("table", table, table.dtype, 2, dev)
    _launch.check("indices", indices, torch.int32, 2, dev)
    v, d = table.shape
    b, t = indices.shape
    if min(v, d) < 1:
        raise ValueError(f"need a table of at least one row and column, got {tuple(table.shape)}")
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0:
        return out  # nothing to launch
    err = library().embedding_bag_launch(
        table.data_ptr(), indices.data_ptr(), out.data_ptr(), b, t, v, d,
        _DTYPES[table.dtype], vec_width(table), _launch.stream(dev),
    )
    _launch.raise_on_error(err, library(), "embedding_bag_error_string", "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
