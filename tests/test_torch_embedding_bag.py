"""The port's embedding substrate and the EmbeddingBag kernel's plain
version against the JAX reference, on the CPU.

* K8's plain version (`kernels/embedding_bag/ref.py`, what `ops` runs on
  the CPU) against `embedding_bag(..., interpret=True)`, the Pallas
  kernel in interpret mode: bit for bit in fp32 and in bf16 (both add
  the live rows in t order in the table's dtype, rounding a bf16 sum
  after every add), sum and mean; max goes to the substrate in both
  packages. All-padding bags give 0; an id >= V reads row V - 1 (the
  kernel's clamped row block). B x T stays <= 200: the interpret grid is
  (B, T), one step per id.
* `embedding_bag_padded` and `embedding_bag_coo` against the reference's
  substrate: fp32 within rtol 1e-6 / atol 1e-6 (one reduction each, the
  order of its adds not fixed); bf16 within 2^-7 relative and 2^-7 times
  the output's largest magnitude (torch's bf16 sum accumulates in fp32
  and rounds once; a bf16 reduction in another order differs by a few
  ulps of the largest term). NaN rows (ids >= V, `jnp.take`'s fill),
  empty bags and weights included.
* `hash_bucket` bit for bit, over the whole int32 range.
* `EmbeddingTableSpec.lookup` / `lookup_single` as the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.embeddings import EmbeddingTableSpec as JaxSpec  # noqa: E402
from repro.embeddings import bag as jbag  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag  # noqa: E402
from repro_torch.convert import _leaf  # noqa: E402
from repro_torch.embeddings import (  # noqa: E402
    EmbeddingTableSpec,
    embedding_bag_coo,
    embedding_bag_padded,
    hash_bucket,
)
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as eb_kernel  # noqa: E402

_JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _table(v: int, d: int, dtype: str, seed: int, scale: float = 1.0):
    """The same table for both packages: (jnp array, torch tensor)."""
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    jt = jnp.asarray(base).astype(_JNP[dtype])
    return jt, _leaf(np.asarray(jt))


def _indices(b: int, t: int, v: int, seed: int, oob: bool = False) -> np.ndarray:
    """[B, T] int32 ids in [-1, V) with extra -1 padding, an all-padding
    row 0, and (``oob``) a few ids in [V, V + 5)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, v, (b, t)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.3] = -1
    idx[0] = -1
    if oob:
        idx[1:, 0] = rng.integers(v, v + 5, (b - 1,))
    return idx


def _bits(x) -> np.ndarray:
    """A float array as integers of its width (bf16 via its bits), for
    bit-for-bit comparison."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


# -- K8: the plain version against the Pallas kernel in interpret mode ---------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize(
    "v,d,b,t,scale",
    [
        (50, 8, 5, 40, 10.0),  # bf16 sums near 142: rounding after every add shows
        (30, 18, 6, 20, 1.0),  # DIN's width: the scalar path of the kernel
        (20, 1, 8, 12, 1.0),  # Wide&Deep's wide table
        (40, 130, 3, 7, 1.0),  # D not a multiple of 4, several column chunks
    ],
)
def test_kernel_plain_version_matches_pallas_bit_for_bit(v, d, b, t, scale, combiner, dtype):
    jt, tt = _table(v, d, dtype, seed=v + d, scale=scale)
    idx = _indices(b, t, v, seed=b * t)
    ref = jax_embedding_bag(jt, jnp.asarray(idx), combiner, interpret=True)
    out = embedding_bag(tt, torch.from_numpy(idx), combiner)
    assert out.dtype == tt.dtype and out.shape == (b, d)
    np.testing.assert_array_equal(_torch_bits(out), _bits(ref))
    assert not out[0].any()  # the all-padding bag is 0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ids_past_the_table_read_its_last_row_as_the_pallas_kernel(dtype):
    """An id >= V: the Pallas kernel's row block is clamped to row V - 1
    (the substrate's `jnp.take` would give NaN instead)."""
    v, d = 12, 8
    jt, tt = _table(v, d, dtype, seed=3)
    idx = _indices(6, 9, v, seed=4, oob=True)
    for combiner in ("sum", "mean"):
        ref = jax_embedding_bag(jt, jnp.asarray(idx), combiner, interpret=True)
        out = embedding_bag(tt, torch.from_numpy(idx), combiner)
        np.testing.assert_array_equal(_torch_bits(out), _bits(ref))
        assert torch.isfinite(out.float()).all()
    # the substrate fills NaN for the same ids, in both packages
    assert torch.isnan(embedding_bag_padded(tt, torch.from_numpy(idx))[1:].float()).all()


def test_bf16_kernel_differs_from_the_substrate_as_the_reference():
    """In bf16 the kernel rounds after every add and the substrate sums in
    one reduction: different functions in both packages, by the same
    amounts (V 50, D 8, T 40, a table scaled by 10)."""
    jt, tt = _table(50, 8, "bf16", seed=58, scale=10.0)
    idx = _indices(5, 40, 50, seed=200)
    jk = np.asarray(jax_embedding_bag(jt, jnp.asarray(idx), "sum", interpret=True), np.float32)
    js = np.asarray(jbag.embedding_bag_padded(jt, jnp.asarray(idx)), np.float32)
    tk = embedding_bag(tt, torch.from_numpy(idx)).float().numpy()
    ts = embedding_bag_padded(tt, torch.from_numpy(idx)).float().numpy()
    np.testing.assert_array_equal(tk, jk)
    assert np.abs(tk - ts).max() > 0 and np.abs(jk - js).max() > 0


def test_max_goes_to_the_substrate():
    jt, tt = _table(25, 8, "fp32", seed=9)
    idx = _indices(7, 6, 25, seed=9)
    before = embedding_bag_ref.calls
    out = embedding_bag(tt, torch.from_numpy(idx), "max")
    assert embedding_bag_ref.calls == before
    ref = jax_embedding_bag(jt, jnp.asarray(idx), "max", interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not out[0].any()  # an empty bag under max is 0


def test_cpu_runs_the_plain_version_and_never_launches():
    _, tt = _table(10, 4, "fp32", seed=0)
    idx = torch.from_numpy(_indices(3, 5, 10, seed=0))
    launches, calls = eb_kernel.embedding_bag_cuda.launches, embedding_bag_ref.calls
    embedding_bag(tt, idx, "sum")
    embedding_bag(tt, idx, "mean")
    assert embedding_bag_ref.calls == calls + 2
    assert eb_kernel.embedding_bag_cuda.launches == launches
    with pytest.raises(ValueError, match="unknown combiner"):
        embedding_bag(tt, idx, "median")


# -- the substrate ---------------------------------------------------------------

def _close(out: torch.Tensor, ref, dtype: str) -> None:
    got, want = out.float().numpy(), np.asarray(ref, np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        finite = np.isfinite(want)
        scale = np.abs(want[finite]).max() if finite.any() else 0.0
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7 * scale)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_embedding_bag_padded_matches_reference(combiner, dtype, weighted):
    v, d, b, t = 40, 6, 7, 9
    jt, tt = _table(v, d, dtype, seed=11)
    idx = _indices(b, t, v, seed=12, oob=True)
    idx[2, 0] = -1  # row 2 keeps only in-range ids
    w = np.random.default_rng(13).random((b, t)).astype(np.float32)
    jw = jnp.asarray(w).astype(_JNP[dtype]) if weighted else None
    tw = _leaf(np.asarray(jw)) if weighted else None
    ref = jbag.embedding_bag_padded(jt, jnp.asarray(idx), combiner, jw)
    out = embedding_bag_padded(tt, torch.from_numpy(idx), combiner, tw)
    assert out.dtype == tt.dtype
    _close(out, ref, dtype)
    nan_rows = np.isnan(out.float().numpy()).all(axis=1)
    np.testing.assert_array_equal(nan_rows, [False, True, False] + [True] * (b - 3))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_embedding_bag_coo_matches_reference(combiner, dtype, weighted):
    """Ragged bags, an empty segment (2), a negative id (counted from the
    end, as `jnp.take`), ids past the table (NaN), and segment ids
    outside [0, num_segments) (dropped)."""
    v, d, nnz, nseg = 30, 5, 24, 6
    rng = np.random.default_rng(21)
    jt, tt = _table(v, d, dtype, seed=21)
    idx = rng.integers(0, v, (nnz,)).astype(np.int32)
    seg = rng.integers(0, nseg, (nnz,)).astype(np.int32)
    seg[seg == 2] = 3
    idx[0], seg[0] = -2, 0  # row V - 2
    idx[1], seg[1] = v + 1, 5  # segment 5 is NaN
    seg[2], seg[3] = -1, nseg  # dropped
    w = rng.random((nnz,)).astype(np.float32)
    jw = jnp.asarray(w).astype(_JNP[dtype]) if weighted else None
    tw = _leaf(np.asarray(jw)) if weighted else None
    ref = jbag.embedding_bag_coo(jt, jnp.asarray(idx), jnp.asarray(seg), nseg, combiner, jw)
    out = embedding_bag_coo(tt, torch.from_numpy(idx), torch.from_numpy(seg), nseg, combiner, tw)
    assert out.dtype == _leaf(np.asarray(ref)).dtype
    _close(out, ref, dtype)
    empty = out[2].float()
    assert (empty == (-torch.inf if combiner == "max" else 0.0)).all()


def test_hash_bucket_is_bit_for_bit():
    rng = np.random.default_rng(5)
    ids = np.concatenate([
        rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, 20_000),
        [0, -1, 1, np.iinfo(np.int32).max, np.iinfo(np.int32).min],
    ]).astype(np.int32)
    for buckets, salt in [(1000, 0x9E3779B9), (4_000_000, 0x9E3779B9), (7, 12345)]:
        ref = np.asarray(jbag.hash_bucket(jnp.asarray(ids), buckets, salt))
        out = hash_bucket(torch.from_numpy(ids), buckets, salt)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_table_lookups_match_reference(combiner):
    spec = EmbeddingTableSpec("items", vocab_size=30, dim=6, combiner=combiner)
    jspec = JaxSpec("items", vocab_size=30, dim=6, combiner=combiner)
    jt, tt = _table(30, 6, "fp32", seed=31)
    idx = _indices(5, 8, 30, seed=32)
    _close(spec.lookup(tt, torch.from_numpy(idx)), jspec.lookup(jt, jnp.asarray(idx)), "fp32")
    single = np.array([[0, -1, 29], [30, 5, 7]], np.int32)  # -1 reads row 0, 30 is NaN
    _close(spec.lookup_single(tt, torch.from_numpy(single)),
           jspec.lookup_single(jt, jnp.asarray(single)), "fp32")
    table = spec.init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    assert table.shape == (30, 6) and table.dtype == torch.bfloat16
    assert 0.2 < float(table.float().std()) * 6**0.5 < 2.0  # the reference's 1/sqrt(dim) scale
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        spec.spec()
