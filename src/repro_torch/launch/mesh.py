"""Production and debug meshes for the dry run (the reference's
`repro/launch/mesh.py`).

Single pod: 16 x 16 = 256 ranks (data x model). Multi-pod: 2 pods x 256 =
512 ranks with a leading pure-DP `pod` axis, built as a (pod+data 32,
model 16) mesh: every spec of the reference shards over pod and data
together or over neither, so the two axes are one dimension of 32 ranks
(a collective over both is one collective, as GSPMD issues it), and
DTensor's redistribution planner, which searches the layouts of every
mesh dimension, takes minutes an op over three. The ranks are a fake
process group (`torch.testing._internal.distributed.fake_pg`: every
collective returns at once), so a mesh of any size exists in one process
on a host without a card; the dry run's tensors are meta tensors, and no
collective moves data.

Both builders are context managers, made on call and never at import:
the default process group is global to the process, so each builds one,
yields the `DeviceMesh` and destroys the group on exit, and refuses to
start where a default group already exists. The mesh's device type is
"cuda", the target: DTensor picks its collectives by it (a "cpu" mesh
has no all-to-all and gathers instead).
"""
from __future__ import annotations

import contextlib
import math

__all__ = ["make_debug_mesh", "make_production_mesh"]


@contextlib.contextmanager
def _fake_process_group(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _meta_shape_propagation():
    """On a build of torch without CUDA, DTensor's shape propagation for a
    "cuda" mesh runs its ops on meta tensors instead of fake CUDA ones:
    the same shapes and strides, where a copy of a fake CUDA tensor (a
    `contiguous` in a decomposition) needs a CUDA build. A build with
    CUDA (the card's) is left as it is."""
    import torch

    if torch.backends.cuda.is_built():
        yield
        return
    from torch.distributed.tensor import _op_schema

    rebuild = _op_schema._rebuild_tensor_from_dtensor_meta

    def on_meta(arg):
        m = arg.tensor_meta
        return torch.empty_strided(m.shape, m.stride, dtype=m.dtype, device="meta")

    _op_schema._rebuild_tensor_from_dtensor_meta = on_meta
    try:
        yield
    finally:
        _op_schema._rebuild_tensor_from_dtensor_meta = rebuild


@contextlib.contextmanager
def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    with _fake_process_group(math.prod(shape)), _meta_shape_propagation():
        yield init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Context manager yielding the (data 16, model 16) pod mesh, or the
    (pod 2 x data 16, model 16) multi-pod one, on a fake group."""
    if multi_pod:
        return _mesh((32, 16), ("pod+data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2, *, pod: int = 0):
    """Context manager yielding a small mesh on a fake group (tests); with
    ``pod``, the pod and data axes are one dimension, as in
    `make_production_mesh`."""
    if pod:
        return _mesh((pod * data, model), ("pod+data", "model"))
    return _mesh((data, model), ("data", "model"))
