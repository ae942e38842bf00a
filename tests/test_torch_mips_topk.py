"""The port's exact top-K MIPS (`repro_torch.kernels.mips_topk`, the
retriever="pallas" route) and `repro_torch.mips.streaming` against the
JAX reference's, on the CPU.

The port's wrapper runs its plain PyTorch version here (CPU tensors);
the reference runs its Pallas kernel in interpret mode. Tolerances:
scores rtol 1e-5 / atol 1e-6 (fp32 sums in another order); ids compared
as sorted sets, exactly (ties may be broken in another order). The
kernel itself is held to the plain version on the card by
`chip_smoke.py`.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_common import assert_topk_equal, data  # noqa: E402

from repro.kernels.mips_topk import mips_topk as jax_mips_topk  # noqa: E402
from repro.mips.streaming import topk_streaming as jax_topk_streaming  # noqa: E402
from repro_torch.kernels.mips_topk import kernel, mips_topk, ops  # noqa: E402
from repro_torch.mips.streaming import topk_streaming  # noqa: E402


@pytest.mark.parametrize(
    "b,p,l,k",
    [
        (5, 3000, 24, 64),  # B not a tile multiple, P ragged against the blocks
        (3, 700, 16, 10),   # P below one reference block
        (9, 1024, 8, 1),    # P a block multiple, K = 1
    ],
)
def test_mips_topk_matches_reference(b, p, l, k):
    items, q = data(p, l, b, seed=p + k)
    ref = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), k, interpret=True)
    out = mips_topk(torch.from_numpy(q), torch.from_numpy(items), k)
    assert out.indices.dtype == torch.int32
    assert bool((out.scores[:, :-1] >= out.scores[:, 1:]).all())  # sorted descending
    assert_topk_equal(out, ref)


@pytest.mark.parametrize("p,block", [(1000, 4096), (1000, 256), (513, 128)])
def test_streaming_matches_reference(p, block):
    items, q = data(p, 12, 4, seed=block)
    ref = jax_topk_streaming(jnp.asarray(q), jnp.asarray(items), 20, block_items=block)
    out = topk_streaming(torch.from_numpy(q), torch.from_numpy(items), 20, block_items=block)
    assert_topk_equal(out, ref)
    # the exact dense top-K, as the reference's streaming scan gives it
    dense = torch.topk(torch.from_numpy(q) @ torch.from_numpy(items).T, 20)
    np.testing.assert_allclose(out.scores.numpy(), dense.values.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block_items", [None, 128])
def test_k_above_the_catalog_fills_dead_slots_as_the_reference(block_items):
    """K > P (the plan clamps K, so no plan reaches it): the reference
    (default tiling and 128-row blocks) and the port fill the empty slots
    alike, id -1 at score -3e38, after the P live ones."""
    items, q = data(5, 8, 3, seed=7)
    kw = {} if block_items is None else {"block_items": block_items}
    ref = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), 8, interpret=True, **kw)
    out = mips_topk(torch.from_numpy(q), torch.from_numpy(items), 8)
    np.testing.assert_array_equal(np.asarray(ref.indices)[:, 5:], -1)
    np.testing.assert_array_equal(out.indices[:, 5:].numpy(), -1)
    np.testing.assert_array_equal(np.asarray(ref.scores)[:, 5:], np.float32(-3e38))
    np.testing.assert_array_equal(out.scores[:, 5:].numpy(), np.float32(-3e38))
    assert_topk_equal(out, ref)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and never the kernel."""
    items, q = data(200, 8, 3, seed=0)
    kernel_before = ops._kernel.mips_topk_cuda.launches
    plain_before = ops._ref.mips_topk_ref.calls
    mips_topk(torch.from_numpy(q), torch.from_numpy(items), 4)
    assert ops._kernel.mips_topk_cuda.launches == kernel_before
    assert ops._ref.mips_topk_ref.calls == plain_before + 1


@pytest.mark.parametrize("p", [1, 63, 64, 3000, 750_000])
def test_chunks_cover_the_catalog_about_once_per_sm(p):
    """The catalog is cut into at most one chunk per SM, each a whole
    number of tiles, covering every row exactly once."""
    chunks, per = kernel.chunks_for(p, 64, 132)
    assert 1 <= chunks <= 132 and per % 64 == 0
    assert (chunks - 1) * per < p <= chunks * per
