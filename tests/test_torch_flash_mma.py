"""The arithmetic of the tensor-core flash-attention kernels (K9 and K10),
emulated on the CPU by `repro_torch.kernels.flash_attention.ref`'s
`flash_attention_mma` and `flash_attention_bwd_mma`, against the JAX
reference's Pallas kernels in interpret mode, forward and backward, fp32
and bf16, head widths 16-256 with the soft-cap, windows and q_offset.

The emulation is what the kernels compute: bf16 products exact and
summed in fp32, the scale applied after the sum, p and ds split into
bf16 terms, fp32 inputs split into tf32 terms (3xTF32).

Tolerances are the chip gates' own (`chip_smoke.py`), by which the card's
kernels are held to their plain versions:
* forward out, fp32: rtol 1e-5, atol 1e-6 + 1e-5 max |out| (sums of terms
  of both signs); bf16: rtol 2^-7 (one bf16 ulp), atol 1e-6;
* lse: rtol 1e-5, atol 1e-5;
* dq, dk, dv, fp32: rtol 1e-5, atol 1e-6 + 1e-5 max |grad|; bf16: rtol
  2^-7, atol 1e-6 + 1e-5 max |grad|.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.backward import flash_backward_pallas  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from test_torch_flash_attention import _bhsd, _pad, _to_jax, _to_torch  # noqa: E402

RTOL, ATOL, BF16_RTOL = 1e-5, 1e-6, 2.0**-7

# every head width, with the soft-cap, windows, q_offset and a non-causal case
CASES = [
    dict(bh=2, sq=77, skv=77, dh=16, causal=True, window=8, cap=50.0, q_offset=0),
    dict(bh=2, sq=77, skv=77, dh=32, causal=True, window=None, cap=50.0, q_offset=0),
    dict(bh=2, sq=130, skv=130, dh=64, causal=True, window=64, cap=None, q_offset=0),
    dict(bh=1, sq=40, skv=130, dh=128, causal=True, window=8, cap=50.0, q_offset=90),
    dict(bh=1, sq=100, skv=100, dh=256, causal=False, window=None, cap=50.0, q_offset=0),
]
DTYPES = ["bf16", "fp32"]


def _gate(got: torch.Tensor, want, *, rtol: float, atol: float, sums: bool = False):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if sums:
        atol = atol + rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _kw(c: dict) -> dict:
    return dict(causal=c["causal"], window=c["window"], logit_cap=c["cap"],
                q_offset=c["q_offset"])


@functools.cache
def _reference(case: int, bf16: bool):
    """The padded inputs and the reference's forward and backward (the
    Pallas kernels in interpret mode, 128-row tiles), as numpy."""
    c = CASES[case]
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (_pad(a, 128) for a in _bhsd(c["bh"], c["sq"], c["skv"], c["dh"], seed=40 + case))
    do = _pad(np.random.default_rng(50 + case).standard_normal(
        (c["bh"], c["sq"], c["dh"])).astype(np.float32), 128)
    # the inputs in their dtype's values, as both sides see them
    q, k, v, do = (_to_torch(a, dtype).float().numpy() for a in (q, k, v, do))
    jq, jk, jv, jdo = (_to_jax(a, dtype) for a in (q, k, v, do))
    out, lse = flash_attention_pallas(jq, jk, jv, seq_q=c["sq"], seq_kv=c["skv"], tile_q=128,
                                      tile_kv=128, interpret=True, **_kw(c))
    out32 = np.asarray(out.astype(jnp.float32))
    dsum = (do * out32).sum(-1)
    grads = flash_backward_pallas(jq, jk, jv, jdo, lse, jnp.asarray(dsum), seq_q=c["sq"],
                                  seq_kv=c["skv"], tile_q=128, tile_kv=128, interpret=True,
                                  **_kw(c))
    return (q, k, v, do), (out32, np.asarray(lse)), dsum, tuple(
        np.asarray(g.astype(jnp.float32)) for g in grads)


def _inputs(case: int, dtype: str):
    bf16 = dtype == "bf16"
    arrays, fwd, dsum, grads = _reference(case, bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    return [_to_torch(a, dtype) for a in arrays], fwd, dsum, grads


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_forward_emulation_meets_the_chip_gates(case, dtype):
    c = CASES[case]
    (q, k, v, _), (jout, jlse), _, _ = _inputs(case, dtype)
    out, lse = ref.flash_attention_mma(q, k, v, seq_kv=c["skv"], **_kw(c))
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    rows = slice(0, c["sq"])
    if dtype == "bf16":
        _gate(out[:, rows], jout[:, rows], rtol=BF16_RTOL, atol=ATOL)
    else:
        _gate(out[:, rows], jout[:, rows], rtol=RTOL, atol=ATOL, sums=True)
    _gate(lse[:, rows], jlse[:, rows], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_backward_emulation_meets_the_chip_gates(case, dtype):
    c = CASES[case]
    (q, k, v, do), (_, jlse), dsum, jgrads = _inputs(case, dtype)
    grads = ref.flash_attention_bwd_mma(
        q, k, v, do, torch.tensor(jlse), torch.tensor(dsum), seq_kv=c["skv"], **_kw(c),
    )
    for got, want in zip(grads, jgrads):
        assert got.dtype == q.dtype
        scale = float(np.abs(want).max())
        if dtype == "bf16":
            _gate(got, want, rtol=BF16_RTOL, atol=ATOL + RTOL * scale)
        else:
            _gate(got, want, rtol=RTOL, atol=ATOL, sums=True)


def test_splits_keep_what_they_claim():
    """bf16 hi + lo keeps ~16 bits of x, tf32 big + small ~21, three bf16
    terms (the forward's p) ~24; an exact bf16 value is its own first term; tf32 rounding
    is to nearest, ties away from zero."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = ref._bf16_terms(x, 2)
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0**-16
    big = ref._tf32(x)
    small = ref._tf32(x - big, truncate=True)  # as the mma reads x - big
    assert float(((big + small - x).abs() / x.abs()).max()) < 2.0**-20
    t = ref._bf16_terms(x, 3)
    assert float(((t[0] + t[1] + t[2] - x).abs() / x.abs()).max()) < 2.0**-23
    xb = x.to(torch.bfloat16).float()
    assert torch.equal(ref._bf16_terms(xb, 2)[1], torch.zeros_like(xb))
    ties = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12])
    assert ref._tf32(ties).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]
    assert ref._tf32(ties, truncate=True).tolist() == [1.0, -1.0, 1.0]
