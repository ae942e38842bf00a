"""Helpers shared by the `test_torch_*` parity tests (this module holds
no tests): numpy inputs from a seed, JAX-built IVF indexes carried
across to the port, the TopK comparison, and the dry run's cells at
SMOKE widths (`small_cell`).

Tolerances of the TopK comparison: scores rtol=1e-5, atol=1e-6 (fp32
sums taken in another order); ids compared as sorted sets, exactly
(top-K ties may be broken in another order)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.mips import build_ivf as jax_build_ivf  # noqa: E402
from repro_torch.convert import ivf_index_from_numpy  # noqa: E402


def data(p: int, l: int, b: int, seed: int):
    """(items [p, l], queries [b, l]) float32, standard normal."""
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((p, l)).astype(np.float32)
    q = rng.standard_normal((b, l)).astype(np.float32)
    return items, q


@functools.lru_cache(maxsize=None)
def jax_index(p: int, l: int, c: int, seed: int, key: int, **kw):
    """(items, the reference's IVFIndex over them), built once per
    geometry: the reference build compiles anew for every shape."""
    items, _ = data(p, l, 1, seed)
    return items, jax_build_ivf(
        jax.random.PRNGKey(key), jnp.asarray(items), num_clusters=c, **kw
    )


def to_port(index):
    """The reference's IVFIndex as the port's, through `convert`."""
    return ivf_index_from_numpy(
        np.asarray(index.centroids), np.asarray(index.lists),
        np.asarray(index.list_embs), index.num_items,
    )


def assert_topk_equal(port, ref):
    np.testing.assert_allclose(
        port.scores.cpu().numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.sort(port.indices.cpu().numpy(), -1), np.sort(np.asarray(ref.indices), -1)
    )


def small_cell(monkeypatch, arch: str, shape: str, **cfg_kw) -> None:
    """The arch's ``shape`` cell at SMOKE widths, for the dry run's
    programs (`repro_torch.launch.specs`): its CONFIG becomes SMOKE_CONFIG
    with ``cfg_kw`` and the cell a small one of the same kind."""
    import dataclasses

    from repro_torch.configs import get_arch

    mod = get_arch(arch)
    monkeypatch.setattr(mod, "CONFIG", dataclasses.replace(mod.SMOKE_CONFIG, **cfg_kw))
    cell = mod.SHAPES[shape]
    small = {"train": dict(global_batch=16, seq_len=32),
             "prefill": dict(global_batch=4, seq_len=64),
             "decode": dict(global_batch=4, seq_len=64)}.get(cell.kind, {})
    if mod.FAMILY == "gnn":
        small = dict(n_nodes=64, n_edges=256, global_batch=4, d_feat=8)
    monkeypatch.setattr(mod, "SHAPES", {**mod.SHAPES, shape: dataclasses.replace(cell, **small)})
