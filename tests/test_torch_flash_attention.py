"""The port's flash attention forward (`repro_torch.kernels.flash_attention`,
K9's plain version and wrapper) against the JAX reference's, on the CPU;
the backward (K10) is in `test_torch_flash_backward.py`, which shares
this file's inputs and tolerances.

Inputs come from numpy with a seed and go to both packages. The
reference's Pallas kernels run in interpret mode. Tolerances:
* fp32: rtol 1e-5 / atol 1e-6 for outputs and lse (fp32 sums taken in
  another order);
* bf16 outputs: both sides compute in fp32 from the same bf16 inputs and
  round the result to bf16, so a value near a rounding boundary may land
  one bf16 ulp apart: rtol 2^-7 (one ulp at the bottom of a binade) /
  atol 1e-6. lse stays fp32 (rtol 1e-5 / atol 1e-5: |lse| is ~5-60).
(`_close` also holds the backward file's gradient tolerances.) The
hand-written kernel is held to this plain version on the card by
`chip_smoke.py`.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

BF16_RTOL = 2.0**-7


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dtype)


def _to_jax(a: np.ndarray, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )


def _close(port: torch.Tensor, want, dtype, *, lse: bool = False, grad: bool = False,
           group_sum: bool = False):
    """The tolerances of this file and of `test_torch_flash_backward.py`:
    ``grad`` for dq, dk, dv (sums of terms of both signs: fp32 atol 1e-6
    max |want|), ``group_sum`` for bf16 dk, dv summed over a GQA group
    (rtol 2^-6, atol 2^-8 max |want|)."""
    got = port.float().numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if lse:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif dtype == torch.bfloat16 and group_sum:
        np.testing.assert_allclose(got, want, rtol=2 * BF16_RTOL, atol=2.0**-8 * scale)
    elif dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * (scale if grad else 1.0))


def _bhsd(bh: int, sq: int, skv: int, dh: int, seed: int):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((bh, sq, dh)).astype(np.float32),
        rng.standard_normal((bh, skv, dh)).astype(np.float32),
        rng.standard_normal((bh, skv, dh)).astype(np.float32),
    )


def _pad(x: np.ndarray, mult: int) -> np.ndarray:
    return np.pad(x, ((0, 0), (0, (-x.shape[1]) % mult), (0, 0)))


# the K9 grid: ragged S, windows, the soft-cap, q_offset (a chunk that
# continues a prefix), causal and not
GRID = [
    dict(bh=3, sq=200, skv=200, dh=32, causal=True, window=None, cap=None, q_offset=0),
    dict(bh=2, sq=130, skv=130, dh=16, causal=True, window=8, cap=50.0, q_offset=0),
    dict(bh=2, sq=256, skv=256, dh=64, causal=True, window=64, cap=None, q_offset=0),
    dict(bh=2, sq=60, skv=188, dh=32, causal=True, window=64, cap=50.0, q_offset=128),
    dict(bh=1, sq=100, skv=140, dh=16, causal=False, window=None, cap=50.0, q_offset=0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_plain_version_matches_pallas_kernel(case, dtype):
    """out and lse of the plain version against `flash_attention_pallas`
    (interpret mode) on the same padded inputs, 128-row tiles."""
    c = GRID[case]
    q, k, v = _bhsd(c["bh"], c["sq"], c["skv"], c["dh"], seed=case)
    q, k, v = _pad(q, 128), _pad(k, 128), _pad(v, 128)
    kw = dict(causal=c["causal"], window=c["window"], logit_cap=c["cap"],
              q_offset=c["q_offset"])
    jout, jlse = flash_attention_pallas(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype), seq_q=c["sq"],
        seq_kv=c["skv"], tile_q=128, tile_kv=128, interpret=True, **kw,
    )
    out, lse = ref.flash_attention_ref(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        seq_kv=c["skv"], **kw,
    )
    assert out.dtype == dtype and lse.dtype == torch.float32
    rows = slice(0, c["sq"])
    _close(out[:, rows], np.asarray(jout.astype(jnp.float32))[:, rows], dtype)
    _close(lse[:, rows], np.asarray(jlse)[:, rows], dtype, lse=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_plain_version_matches_reference_oracle(case, dtype):
    """out against the reference's `flash_attention_ref` on unpadded
    inputs; lse against a logsumexp of the same masked scores."""
    c = GRID[case]
    q, k, v = _bhsd(c["bh"], c["sq"], c["skv"], c["dh"], seed=10 + case)
    kw = dict(causal=c["causal"], window=c["window"], logit_cap=c["cap"],
              q_offset=c["q_offset"])
    jout = jax_flash_ref(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype), **kw)
    out, lse = ref.flash_attention_ref(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), **kw
    )
    _close(out, np.asarray(jout.astype(jnp.float32)), dtype)
    # lse: the log of the softmax's normaliser over the live keys
    qf = _to_torch(q, dtype).double() / c["dh"] ** 0.5
    s = torch.einsum("bqd,bkd->bqk", qf, _to_torch(k, dtype).double())
    if c["cap"] is not None:
        s = c["cap"] * torch.tanh(s / c["cap"])
    qpos = c["q_offset"] + torch.arange(c["sq"])[:, None]
    kpos = torch.arange(c["skv"])[None, :]
    live = torch.ones_like(s[0], dtype=torch.bool)
    if c["causal"]:
        live &= kpos <= qpos
    if c["window"] is not None:
        live &= qpos - kpos < c["window"]
    want = torch.logsumexp(torch.where(live, s, -torch.inf), dim=-1)
    _close(lse, want.numpy(), dtype, lse=True)


@pytest.mark.parametrize(
    "b,s,h,kv,dh,window,cap,dtype",
    [
        (2, 256, 4, 2, 32, None, None, torch.float32),  # GQA n_rep 2
        (1, 300, 4, 4, 16, 128, 50.0, torch.float32),  # n_rep 1; the reference pads to 384
        (2, 150, 2, 1, 16, 8, 50.0, torch.bfloat16),  # Gemma's local layer, n_rep 2
    ],
)
def test_ops_wrapper_matches_reference_ops(b, s, h, kv, dh, window, cap, dtype):
    """The [B, S, H, D] wrapper (GQA repeat, ragged S) against the
    reference's jitted `ops.flash_attention` at 128-row tiles (the port
    has no tiles to set: its result does not depend on them)."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, logit_cap=cap)
    jout = jax_flash_ops(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                         tile_q=128, tile_kv=128, interpret=True, **kw)
    out = ops.flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                              _to_torch(v, dtype), **kw)
    assert out.shape == (b, s, h, dh) and out.dtype == dtype
    _close(out, np.asarray(jout.astype(jnp.float32)), dtype)
    # the lse beside it: [B, H, S], rows of the plain version's
    out2, lse = ops.flash_attention_fwd(_to_torch(q, dtype), _to_torch(k, dtype),
                                        _to_torch(v, dtype), **kw)
    assert torch.equal(out2, out) and lse.shape == (b, h, s)


def test_cpu_tensors_take_the_plain_version():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 8, 1, 16))
    launches = kernel.flash_attention_fwd_cuda.launches
    calls = ref.flash_attention_ref.calls
    ops.flash_attention(q, k, k)
    assert kernel.flash_attention_fwd_cuda.launches == launches
    assert ref.flash_attention_ref.calls == calls + 1


def test_rows_without_a_live_key_are_refused():
    """A query row past seq_kv + window - 1 sees no key; its output would
    depend on the tiling, so the wrapper refuses it."""
    q = torch.zeros((1, 4, 1, 16))
    k = torch.zeros((1, 8, 1, 16))
    ops.flash_attention(q, k, k, window=4, q_offset=7)  # last row at 10 sees key 7
    with pytest.raises(ValueError, match="no live key"):
        ops.flash_attention(q, k, k, window=4, q_offset=8)


def test_bf16_inputs_cross_bit_for_bit():
    """The helper the parity tests lean on: numpy bf16 -> torch bf16."""
    a = np.asarray([1.0, -2.5, 3.140625], dtype=ml_dtypes.bfloat16)
    from repro_torch.convert import lm_params_from_numpy

    got = lm_params_from_numpy({"embed": a, "layers": {}})["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))
