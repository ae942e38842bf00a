"""The port's flash-attention backward (`repro_torch.kernels.flash_attention`:
K10's plain version, and the autograd backward of the [B, S, H, D]
wrapper) against the JAX reference's, on the CPU, with the inputs and
tolerances of `test_torch_flash_attention.py`:
* fp32: rtol 1e-5 and atol 1e-6 times the gradient's max |value| (dq,
  dk, dv are sums of terms of both signs, whose fp32 error in another
  order scales with the terms, not with the sum);
* bf16: one bf16 ulp (rtol 2^-7, atol 1e-6): both sides compute in fp32
  from the same bf16 inputs and round the result; through the wrapper,
  dk and dv are sums over a GQA group of bf16 values that may each be
  one ulp apart, so rtol 2^-6 and atol one bf16 ulp of the largest value
  (2^-8 max |value|: the group's terms may cancel).
The reference's Pallas kernels run in interpret mode. The hand-written
kernel is held to this plain version on the card by `chip_smoke.py`.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash_ops  # noqa: E402
from repro.kernels.flash_attention.backward import flash_backward_pallas  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from test_torch_flash_attention import (  # noqa: E402
    GRID, _bhsd, _close, _pad, _to_jax, _to_torch,
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_backward_plain_version_matches_pallas_kernel(case, dtype):
    """dq, dk, dv of K10's plain version against `flash_backward_pallas`
    (interpret mode) on the same padded inputs, 128-row tiles, both given
    the same lse and D = rowsum(dO * O) (from K9's plain version, which
    the forward tests hold to the reference's kernel)."""
    c = GRID[case]
    q, k, v = _bhsd(c["bh"], c["sq"], c["skv"], c["dh"], seed=20 + case)
    do = np.random.default_rng(30 + case).standard_normal(q.shape).astype(np.float32)
    q, k, v, do = _pad(q, 128), _pad(k, 128), _pad(v, 128), _pad(do, 128)
    do[:, c["sq"]:] = 0.0  # the padded rows' cotangent, as the reference's slice gives
    kw = dict(causal=c["causal"], window=c["window"], logit_cap=c["cap"],
              q_offset=c["q_offset"])
    tq, tk, tv, tdo = (_to_torch(a, dtype) for a in (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, seq_kv=c["skv"], **kw)
    dsum = (tdo.float() * out.float()).sum(dim=-1)
    jdq, jdk, jdv = flash_backward_pallas(
        *(_to_jax(a, dtype) for a in (q, k, v, do)), jnp.asarray(lse.numpy()),
        jnp.asarray(dsum.numpy()), seq_q=c["sq"], seq_kv=c["skv"], tile_q=128, tile_kv=128,
        interpret=True, **kw,
    )
    calls = ref.flash_attention_bwd_ref.calls
    dq, dk, dv = ref.flash_attention_bwd_ref(tq, tk, tv, tdo, lse, dsum, seq_kv=c["skv"], **kw)
    assert ref.flash_attention_bwd_ref.calls == calls + 1
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, np.asarray(want.astype(jnp.float32)), dtype, grad=True)


@pytest.mark.parametrize(
    "b,sq,skv,h,kv,dh,window,cap,q_offset,dtype",
    [
        (2, 150, 150, 4, 2, 32, None, 50.0, 0, torch.float32),  # GQA n_rep 2, cap
        (1, 200, 200, 2, 1, 16, 8, 50.0, 0, torch.float32),  # Gemma's local layer
        (1, 40, 100, 4, 4, 16, 64, 50.0, 60, torch.float32),  # a chunk after a prefix
        (2, 150, 150, 4, 2, 16, 64, 50.0, 0, torch.bfloat16),
    ],
)
def test_autograd_backward_matches_reference_vjp(b, sq, skv, h, kv, dh, window, cap,
                                                 q_offset, dtype):
    """`ops.flash_attention`'s autograd backward (the plain K10 here, GQA
    group-summed) against `jax.vjp` of the reference's jitted
    `ops.flash_attention` in interpret mode, 128-row tiles."""
    rng = np.random.default_rng(sq + dh)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, logit_cap=cap, q_offset=q_offset)
    _, vjp = jax.vjp(lambda a, b_, c_: jax_flash_ops(a, b_, c_, tile_q=128, tile_kv=128,
                                                     interpret=True, **kw),
                     *(_to_jax(a, dtype) for a in (q, k, v)))
    jgrads = vjp(_to_jax(do, dtype))
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    calls = ref.flash_attention_bwd_ref.calls
    ops.flash_attention(tq, tk, tv, **kw).backward(_to_torch(do, dtype))
    assert ref.flash_attention_bwd_ref.calls == calls + 1
    for t, want, summed in ((tq, jgrads[0], False), (tk, jgrads[1], kv < h),
                            (tv, jgrads[2], kv < h)):
        assert t.grad.dtype == dtype and t.grad.shape == t.shape
        _close(t.grad, np.asarray(want.astype(jnp.float32)), dtype, grad=True,
               group_sum=summed)


def test_backward_on_cpu_takes_the_plain_version():
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    k = torch.zeros((1, 8, 1, 16), requires_grad=True)
    launches = kernel.flash_attention_bwd_cuda.launches
    calls = ref.flash_attention_bwd_ref.calls
    ops.flash_attention(q, k, k).sum().backward()
    assert kernel.flash_attention_bwd_cuda.launches == launches
    assert ref.flash_attention_bwd_ref.calls == calls + 1
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
