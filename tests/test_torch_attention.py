"""The port's attention layers (`repro_torch.models.attention`: the
chunked online-softmax prefill and the cached decode) and the LM's
shared layers (`models.layers`: rope, softcap, gated_mlp) against the
JAX reference's, on the CPU, from numpy inputs made with a seed.

Tolerances: fp32 rtol 1e-5 / atol 1e-6 (sums taken in another order);
bf16 rope rtol 2^-7 (both sides rotate in fp32 and round to bf16 once,
so a value may land one bf16 ulp apart) / atol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _to_jax(a: np.ndarray, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )


def _close(port: torch.Tensor, want, dtype):
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=1e-6)




@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None] + 5, (2, 7)).astype(np.int32)
    want = jax_layers.rope(_to_jax(x, dtype), jnp.asarray(pos), 10_000.0)
    got = layers.rope(_to_torch(x, dtype), torch.from_numpy(pos.copy()), 10_000.0)
    assert got.dtype == dtype
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)


def test_softcap_matches_reference():
    x = np.linspace(-300, 300, 101, dtype=np.float32)
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(x), 30.0).numpy(),
        np.asarray(jax_layers.softcap(jnp.asarray(x), 30.0)), rtol=1e-6, atol=1e-5,
    )
    assert layers.softcap(torch.from_numpy(x), None) is not None
    np.testing.assert_array_equal(layers.softcap(torch.from_numpy(x), None).numpy(), x)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches_reference(act):
    """gelu is the tanh approximation on both sides (`jax.nn.gelu`'s
    default); the exact erf form would differ by ~1e-4 here."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) / 4 for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) / 5
    want = jax_layers.gated_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act=act)
    got = layers.gated_mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wd)), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "sq,skv,h,kv,window,cap,q_offset,chunks",
    [
        (40, 40, 4, 2, None, None, 0, 16),  # ragged chunks
        (33, 33, 2, 1, 8, 50.0, 0, 8),
        (12, 30, 4, 4, 6, 50.0, 18, 1024),  # a continuation chunk, one chunk each
    ],
)
def test_chunked_attention_matches_reference(sq, skv, h, kv, window, cap, q_offset, chunks):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, kv, 16)).astype(np.float32)
    kw = dict(causal=True, q_offset=q_offset, window=window, logit_cap=cap,
              q_chunk=chunks, kv_chunk=chunks)
    want = jax_attention.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = attention.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "gqa_einsum,slice_window,window",
    [(False, False, None), (False, False, 5), (True, False, 5), (True, True, 5),
     (True, True, None)],
)
def test_decode_attention_matches_reference(gqa_einsum, slice_window, window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    for cache_len in (3, 9, 12):
        kw = dict(window=window, logit_cap=50.0, gqa_einsum=gqa_einsum,
                  slice_window=slice_window)
        want = jax_attention.decode_attention(
            *(jnp.asarray(a) for a in (q, kc, vc)), cache_len, **kw
        )
        got = attention.decode_attention(
            *(torch.from_numpy(a) for a in (q, kc, vc)), cache_len, **kw
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
