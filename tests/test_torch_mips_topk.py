"""The port's exact top-K MIPS (`repro_torch.kernels.mips_topk`, the
retriever="pallas" route) and `repro_torch.mips.streaming` against the
JAX reference's, on the CPU.

The port's wrapper runs its plain PyTorch version here (CPU tensors);
the reference runs its Pallas kernel in interpret mode. Tolerances:
scores rtol 1e-5 / atol 1e-6 (fp32 sums in another order); ids compared
as sorted sets, exactly (ties may be broken in another order). The
kernel itself is held to the plain version on the card by
`chip_smoke.py`.

`ref.mips_topk_mma`, the emulation of the kernel's 3xTF32 scores, is
held to the reference by `chip_smoke.py`'s gates (`topk_err`: scores
elementwise within rtol 1e-5 / atol 1e-6, ids as sets but for ties with
the K-th score within that tolerance); the card's kernel is held to it
there. The wrapper's geometry (the catalog's chunks, the ring of tiles)
is checked here without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_common import assert_topk_equal, data  # noqa: E402

from repro.kernels.mips_topk import mips_topk as jax_mips_topk  # noqa: E402
from repro.mips.streaming import topk_streaming as jax_topk_streaming  # noqa: E402
from repro_torch.kernels.mips_topk import kernel, mips_topk, ops, ref  # noqa: E402
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


def test_counters_leave_the_answer_the_fake_and_the_cost_unchanged():
    """The op with a counters buffer: the same top-K as without (the CPU
    body counts the queries alone), a fake implementation that takes it,
    and the op walker's cost of a call as before; `mips_topk` passes the
    ambient tracer's buffer."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import jaxpr_cost
    from repro_torch.obs.trace import Tracer, tracing

    items, q = data(3000, 24, 5, seed=7)
    qt, it = torch.from_numpy(q), torch.from_numpy(items)
    counters = torch.zeros(len(kernel.COUNT_FIELDS), dtype=torch.int64)
    bare = ops._op(qt, it, 64)
    counted = ops._op(qt, it, 64, counters)
    assert torch.equal(bare[0], counted[0]) and torch.equal(bare[1], counted[1])
    assert counters.tolist() == [5] + [0] * (len(kernel.COUNT_FIELDS) - 1)
    with FakeTensorMode():
        fs, fi = ops._op(torch.empty(5, 24), torch.empty(3000, 24), 64,
                         torch.zeros(len(kernel.COUNT_FIELDS), dtype=torch.int64))
    assert fs.shape == fi.shape == (5, 64) and fi.dtype == torch.int32
    costs = [jaxpr_cost.analyze(fn, qt, it) for fn in (
        lambda a, b: ops._op(a, b, 64),
        lambda a, b: ops._op(a, b, 64, torch.zeros(len(kernel.COUNT_FIELDS),
                                                   dtype=torch.int64)))]
    assert [(c["flops"], c["bytes"], c["kernel_ops"]) for c in costs] == [
        (costs[0]["flops"], costs[0]["bytes"], {"mips_topk": 1})] * 2
    tracer = Tracer()
    with tracing(tracer):
        out = mips_topk(qt, it, 64)
        mips_topk(qt, it, 64)
    assert torch.equal(out.indices, bare[1])
    assert tracer.counter_totals() == {"mips_topk": [10] + [0] * (len(kernel.COUNT_FIELDS) - 1)}


@pytest.mark.parametrize("p", [1, 63, 64, 3000, 750_000])
def test_chunks_cover_the_catalog_about_once_per_sm(p):
    """The catalog is cut into at most one chunk per SM, each a whole
    number of tiles, covering every row exactly once."""
    chunks, per = kernel.chunks_for(p, 64, 132)
    assert 1 <= chunks <= 132 and per % 64 == 0
    assert (chunks - 1) * per < p <= chunks * per


def _within_chip_gates(out, ref_topk):
    """`chip_smoke.topk_err` on the CPU: sorted scores within rtol 1e-5 /
    atol 1e-6 elementwise; ids equal as sets per row, but for ids whose
    score ties the K-th within that tolerance; dead slots at -3e38."""
    ks, ki = out[0].numpy(), out[1].numpy()
    rs, ri = np.asarray(ref_topk.scores), np.asarray(ref_topk.indices)
    np.testing.assert_allclose(ks, rs, rtol=1e-5, atol=1e-6)
    assert (ks[:, :-1] >= ks[:, 1:]).all()
    for row in range(ks.shape[0]):
        kth = float(rs[row, -1])
        tol = 1e-6 + 1e-5 * abs(kth)
        a, b = set(ki[row].tolist()), set(ri[row].tolist())
        for ids, scores, only in ((ki, ks, a - b), (ri, rs, b - a)):
            for i in only:
                pos = ids[row].tolist().index(i)
                assert abs(float(scores[row, pos]) - kth) <= tol, (row, i)
    assert (ks[ki < 0] == np.float32(-3e38)).all()


@pytest.mark.parametrize(
    "b,p,l,k",
    [
        (40, 3001, 17, 100),  # B > 32 (two query tiles), P ragged, L odd, K not a power of 2
        (5, 777, 100, 256),   # the training width L 100, P ragged
        (33, 2000, 24, 37),   # B = 33, L a multiple of 8, K odd
        (3, 70, 7, 96),       # P below one tile, L < 8, K above P
    ],
)
def test_mma_emulation_within_chip_gates(b, p, l, k):
    """The 3xTF32 scores (each operand split into tf32 big and small, the
    small products summed apart) stay within the fp32 gates of the
    reference's exact top-K."""
    items, q = data(p, l, b, seed=b * p + k)
    want = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), k, interpret=True)
    got = ref.mips_topk_mma(torch.from_numpy(q), torch.from_numpy(items), k)
    assert got[1].dtype == torch.int32 and got[0].shape == (b, k)
    _within_chip_gates(got, want)


def test_mma_emulation_splits_the_products():
    """The emulation is not the fp32 product: the small part of x = 1 +
    2^-12 + 2^-23 is cut to tf32 (2^-12) and small * small is dropped,
    so x * x comes out as 1 + 2^-11; fp32 keeps 2 * 2^-23 and more."""
    x = torch.tensor([[1.0 + 2.0**-12 + 2.0**-23]])
    s, i = ref.mips_topk_mma(x, x, 1)
    assert float(s[0, 0]) == 1.0 + 2.0**-11 and int(i[0, 0]) == 0
    assert float((x @ x.T)[0, 0]) > 1.0 + 2.0**-11 + 2.0**-22


@pytest.mark.parametrize("l,stages", [(8, 4), (24, 4), (100, 4), (150, 3), (227, 2)])
def test_ring_stages_fit_beside_the_top_k_state(l, stages):
    """The ring holds as many 64-row tiles as fit beside the 32 queries'
    top-K state (448 slots of 8 bytes each), up to 4 and at least 2, and
    the whole block stays within a Hopper block's shared memory."""
    assert kernel.ring_stages(l) == stages
    sb = kernel.stage_bytes(l)
    assert sb % 128 == 0 and sb >= kernel.TILE_ITEMS * l * 4 + 32
    assert stages * sb + 32 * 448 * 8 <= 232_448 - 1024


def test_ring_stages_refuse_a_width_two_tiles_cannot_take():
    with pytest.raises(ValueError, match="L=228"):
        kernel.ring_stages(228)


@pytest.mark.parametrize("p", [1, 700, 8192 * 64, 750_000, 10**7])
def test_floor_samples_every_stride_th_row(p):
    """The floor's sample: every stride-th row (stride >= 64) of the
    catalog, at most 8192 rows, every sampled row inside it; at P 750,000
    every 92nd row."""
    stride, m = kernel.sample_rows(p)
    assert stride >= 64 and 1 <= m <= 8192
    assert (m - 1) * stride < p <= m * stride
    if p == 750_000:
        assert (stride, m) == (92, 8153)
