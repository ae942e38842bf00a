"""Fault-tolerant checkpointing, on one device.

  * atomic: written to a temp dir, fsynced, renamed, so a preempted
    writer never corrupts the latest checkpoint;
  * rotated: the last N steps are kept, older ones deleted;
  * verified: the manifest records a crc32 per leaf, checked on restore;
    `restore_checkpoint(fallback=True)` walks back past a corrupt one;
  * a state is a tree of dicts, lists, tuples and NamedTuples whose
    leaves are tensors, numpy arrays or Python scalars. Tensors are
    written as numpy on the host (bf16 as its 16-bit pattern) and come
    back on the template leaf's device, in its dtype.

The reference's module (`repro/train/checkpoint.py`), with its per-shard
writer: `save_sharded` writes an array as per-row-shard npz files and
`restore_sharded` reads any shard of a fresh split of it, elastically
onto another shard count. Their files are the reference's own
(``<name>_sharded/shards.json``, ``shard_%05d.npz`` with key ``rows``), so
either package restores what the other saved. `shard_bounds`'
array_split rule belongs to these files only; the dist step's beta slabs
follow `pad_rows`' ceil rule (`repro_torch.dist.fopo.shard_rows`).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "ARRAYS",
    "CheckpointCorruptError",
    "MANIFEST",
    "SHARDS_MANIFEST",
    "latest_checkpoint",
    "list_checkpoints",
    "restore_checkpoint",
    "restore_sharded",
    "save_checkpoint",
    "save_sharded",
    "set_write_fault",
    "shard_bounds",
]

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification on restore: unreadable archive,
    missing leaves, or a per-array checksum mismatch."""


# test seam for fault injection (repro_torch.health.faults): called with
# (tmp_dir, attempt) after the files are written but BEFORE the atomic
# rename, where a real writer dies. Raising here must leave no step dir
# behind and must be retryable.
_WRITE_FAULT: Callable[[str, int], None] | None = None


def set_write_fault(fn: Callable[[str, int], None] | None) -> None:
    global _WRITE_FAULT
    _WRITE_FAULT = fn


def _leaf_checksum(arr: np.ndarray) -> int:
    """crc32 over an array's raw bytes (contiguous view)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _flatten(tree: Any) -> tuple[list, str]:
    """(leaves in a fixed order, a string of the tree's structure)."""
    leaves: list = []

    def walk(x) -> str:
        if isinstance(x, dict):
            return "{" + ",".join(f"{k!r}:{walk(v)}" for k, v in x.items()) + "}"
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return f"{type(x).__name__}(" + ",".join(walk(v) for v in x) + ")"
        if isinstance(x, (list, tuple)):
            inner = ",".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner})"
        if x is None:
            return "None"
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def _unflatten(template: Any, leaves) -> Any:
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if x is None:
            return None
        return next(it)

    return build(template)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the leaf as a numpy array, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype: str, template) -> Any:
    """The saved array in the template leaf's form: a tensor on its
    device in its dtype, or a numpy array in its dtype."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.array(arr, dtype=np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray) or np.isscalar(template):
        out = np.asarray(arr)
        return out.astype(np.asarray(template).dtype)
    return t


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    *,
    extra: dict | None = None,
    keep: int = 3,
    retries: int = 0,
    backoff: float = 0.05,
) -> str:
    """Atomically write `state` at `step`; returns the step directory.

    Transient write failures (OSError) are retried `retries` times with
    exponential `backoff`; each attempt starts from a fresh temp dir, so
    a failed attempt never leaves a partial step dir behind."""
    os.makedirs(directory, exist_ok=True)
    leaves, structure = _flatten(state)
    arrays, checksums, dtypes = {}, [], []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        checksums.append(_leaf_checksum(arr))
        dtypes.append(dtype)
    manifest = {
        "step": int(step),
        "treedef": structure,
        "num_leaves": len(leaves),
        "checksums": checksums,
        "dtypes": dtypes,
        "extra": extra or {},
    }

    final = os.path.join(directory, f"step_{step:010d}")
    for attempt in range(retries + 1):
        tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
        try:
            np.savez(os.path.join(tmp, ARRAYS), **arrays)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if _WRITE_FAULT is not None:
                _WRITE_FAULT(tmp, attempt)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if attempt < retries:
                time.sleep(backoff * (2**attempt))
                continue
            raise
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        break
    _rotate(directory, keep)
    return final


def _rotate(directory: str, keep: int) -> None:
    steps = sorted(list_checkpoints(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"), ignore_errors=True)


def list_checkpoints(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.isfile(
            os.path.join(directory, name, MANIFEST)
        ):
            out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_checkpoint(directory: str) -> int | None:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# save-sharded arrays: per-row-shard npz files, elastic re-shard on load
# ---------------------------------------------------------------------------

SHARDS_MANIFEST = "shards.json"


def shard_bounds(rows: int, num_shards: int) -> list[tuple[int, int]]:
    """Contiguous row ranges of an even split, the ragged remainder spread
    over the leading shards (np.array_split's rule): the one partition
    shared by `save_sharded` and `restore_sharded`."""
    base, rem = divmod(rows, num_shards)
    bounds, start = [], 0
    for i in range(num_shards):
        end = start + base + (1 if i < rem else 0)
        bounds.append((start, end))
        start = end
    return bounds


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_sharded(directory: str, name: str, array, num_shards: int, *, axis: int = 0) -> str:
    """Atomically write ``array`` (numpy or a tensor, on any device) as
    ``num_shards`` npz files, each shard sliced and copied to the host on
    its own. Layout: ``<directory>/<name>_sharded/{shards.json,
    shard_00000.npz, ...}``, the reference's."""
    os.makedirs(directory, exist_ok=True)
    shape = tuple(int(d) for d in array.shape)
    bounds = shard_bounds(shape[axis], num_shards)
    index = [slice(None)] * len(shape)
    final = os.path.join(directory, f"{name}_sharded")
    tmp = tempfile.mkdtemp(prefix=f".{name}_tmp_", dir=directory)
    try:
        dtype = None
        for i, (start, end) in enumerate(bounds):
            index[axis] = slice(start, end)
            rows = _host(array[tuple(index)])
            dtype = rows.dtype
            np.savez(os.path.join(tmp, f"shard_{i:05d}.npz"), rows=rows)
        manifest = {
            "shape": list(shape),
            "dtype": str(dtype),
            "axis": int(axis),
            "bounds": [list(b) for b in bounds],
        }
        with open(os.path.join(tmp, SHARDS_MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def restore_sharded(
    directory: str,
    name: str,
    *,
    shard_id: int | None = None,
    num_shards: int | None = None,
) -> np.ndarray:
    """Load a save-sharded array, re-sharding elastically.

    ``shard_id=None`` returns the whole array. With ``shard_id`` and
    ``num_shards`` it returns that shard of a fresh `shard_bounds(rows,
    num_shards)` split, whatever the saved shard count: only the saved
    files overlapping the requested rows are opened."""
    path = os.path.join(directory, f"{name}_sharded")
    with open(os.path.join(path, SHARDS_MANIFEST)) as f:
        manifest = json.load(f)
    axis = manifest["axis"]
    dtype = np.dtype(manifest["dtype"])
    rows = manifest["shape"][axis]
    if shard_id is None:
        want = (0, rows)
    else:
        if num_shards is None:
            raise ValueError("num_shards is required with shard_id")
        want = shard_bounds(rows, num_shards)[shard_id]
    pieces = []
    for i, (start, end) in enumerate(tuple(b) for b in manifest["bounds"]):
        lo, hi = max(start, want[0]), min(end, want[1])
        if lo >= hi:
            continue
        with np.load(os.path.join(path, f"shard_{i:05d}.npz")) as z:
            chunk = z["rows"]
        index = [slice(None)] * chunk.ndim
        index[axis] = slice(lo - start, hi - start)
        pieces.append(chunk[tuple(index)])
    out = np.concatenate(pieces, axis=axis) if pieces else np.zeros(
        [0 if i == axis else d for i, d in enumerate(manifest["shape"])], dtype
    )
    return out.astype(dtype, copy=False)


def _restore_one(path: str, template: Any) -> tuple[Any, dict]:
    """Load and verify one checkpoint dir. Raises CheckpointCorruptError
    on any integrity failure, ValueError on a structure mismatch."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    flat_t, structure = _flatten(template)
    if manifest["num_leaves"] != len(flat_t):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, template has {len(flat_t)}"
        )
    if manifest.get("treedef", structure) != structure:
        raise ValueError(
            f"checkpoint structure {manifest['treedef']} differs from the "
            f"template's {structure}"
        )
    checksums = manifest.get("checksums")
    try:
        with np.load(os.path.join(path, ARRAYS)) as z:
            flat = [z[f"leaf_{i}"] for i in range(len(flat_t))]
    except Exception as e:  # any unreadable archive is corruption
        raise CheckpointCorruptError(f"unreadable arrays in {path}: {e}") from e
    if checksums is not None:  # checkpoints without checksums stay loadable
        for i, arr in enumerate(flat):
            got = _leaf_checksum(arr)
            if got != checksums[i]:
                raise CheckpointCorruptError(
                    f"checksum mismatch on leaf_{i} in {path}: "
                    f"{got:#010x} != {checksums[i]:#010x}"
                )
    dtypes = manifest.get("dtypes") or [a.dtype.name for a in flat]
    restored = [_from_numpy(a, d, t) for a, d, t in zip(flat, dtypes, flat_t)]
    return _unflatten(template, restored), manifest.get("extra", {})


def restore_checkpoint(
    directory: str,
    template: Any,
    step: int | None = None,
    *,
    fallback: bool = False,
) -> tuple[int, Any, dict]:
    """Restore into the structure of `template`. Returns (step, state,
    extra).

    Every leaf is crc32-verified against the manifest. On corruption:
    raises `CheckpointCorruptError`, or with `fallback=True` walks back
    through older rotated checkpoints until one verifies, raising only
    when every candidate is corrupt."""
    if step is not None:
        candidates = [step]
    else:
        candidates = sorted(list_checkpoints(directory), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        if not fallback:
            candidates = candidates[:1]
    errors = []
    for s in candidates:
        path = os.path.join(directory, f"step_{s:010d}")
        try:
            state, extra = _restore_one(path, template)
            return s, state, extra
        except CheckpointCorruptError as e:
            if not fallback:
                raise
            errors.append(str(e))
    raise CheckpointCorruptError(
        "all candidate checkpoints corrupt:\n  " + "\n  ".join(errors)
    )
