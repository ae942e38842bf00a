"""The port's LM training steps (`repro_torch.models.lm.make_train_step`
with the port's Adam) against the JAX reference's, on the CPU, on the
kernel path (`use_flash_kernel=True`: the port's flash attention through
its plain versions, the reference's Pallas kernels in interpret mode).
The model, weights and tokens are `test_torch_lm_train.py`'s (Gemma-2's
SMOKE_CONFIG cut to 2 layers, the reference's weights carried across).

Tolerances:
* fp32 trajectories (Adam 1e-3, 1 and 3 steps, microbatch 0 and 2 on
  batch 4): loss rtol 1e-5; moments rtol 1e-4 / atol 1e-5 times the
  leaf's max |moment| (sums of gradients of both signs); parameters rtol
  1e-5 / atol 1e-6 on all but 0.1 % of each leaf's entries, and every
  entry within 2e-2 lr: Adam's update lr g / (|g| + 1e-8) turns an fp32
  difference d in a gradient entry near 0 into an update difference of
  up to lr d / 1e-8 (one entry in a few thousand, ~1e-2 lr, is seen);
* bf16 (2 steps): each leaf's dtype equal to the reference's (params fp32
  and moments bf16 after step 1, all fp32 after step 2); loss rtol 1e-3
  (bf16 matmuls and soft-caps, rounded at other places by XLA and torch);
  moments within 3e-2 relative L2; parameters within 2 (1 + 2^-6) lr per
  step of the reference everywhere (Adam's first update is about lr
  sign(g), its size off 1 by the bf16 rounding of m and v: an entry whose
  gradient sits within bf16 noise of 0 may flip sign), and no more than
  2 % of entries further than lr / 2 apart.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    LEAVES, LR, _cfgs, _dtypes, _flat, _jax_params, _port_params, _tokens,
)


@functools.cache
def _jax_trajectory(microbatch: int, dtype: str, steps: int):
    """[(loss, params, m, v, dtypes of params / m / v)] after each step."""
    _, jcfg = _cfgs(True, microbatch=microbatch, dtype=dtype)
    opt = joptim.adam(LR)
    params = _jax_params(dtype)
    state = opt.init(params)
    step = jax.jit(jax_lm.make_train_step(jcfg, opt))
    out = []
    for i in range(steps):
        x, y = _tokens(10 + i)
        params, state, loss = step(params, state, jnp.asarray(x), jnp.asarray(y))
        out.append(dict(loss=float(loss), params=_flat(params), m=_flat(state["m"]),
                        v=_flat(state["v"]),
                        dtypes=(_dtypes(params), _dtypes(state["m"]), _dtypes(state["v"]))))
    return out


def _port_trajectory(microbatch: int, dtype: str, steps: int):
    cfg, _ = _cfgs(True, microbatch=microbatch, dtype=dtype)
    opt = optim.adam(LR)
    params = _port_params(dtype)
    state = opt.init(params)
    step = lm.make_train_step(cfg, opt)
    out = []
    for i in range(steps):
        x, y = (torch.from_numpy(a) for a in _tokens(10 + i))
        params, state, loss = step(params, state, x, y)
        out.append(dict(loss=float(loss), params=_flat(params), m=_flat(state["m"]),
                        v=_flat(state["v"]),
                        dtypes=(_dtypes(params), _dtypes(state["m"]), _dtypes(state["v"]))))
    return out


@pytest.mark.parametrize("after", [1, 3])
@pytest.mark.parametrize("microbatch", [0, 2], ids=["whole", "micro2"])
def test_train_step_trajectory_matches_reference(microbatch, after):
    """Adam steps on batch 4; microbatch 2 splits it into rows {0, 2} and
    {1, 3}, the reference's strided split."""
    want = _jax_trajectory(microbatch, "float32", 3)[after - 1]
    got = _port_trajectory(microbatch, "float32", after)[-1]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name in LEAVES:
        a, b = got["params"][name], want["params"][name]
        off = np.abs(a - b) > 1e-6 + 1e-5 * np.abs(b)
        assert off.mean() <= 1e-3, name
        assert np.abs(a - b).max() <= 2e-2 * LR, name
        for mom in ("m", "v"):
            b = want[mom][name]
            np.testing.assert_allclose(got[mom][name], b, rtol=1e-4,
                                       atol=1e-5 * np.abs(b).max(), err_msg=f"{mom} {name}")
    assert got["dtypes"] == want["dtypes"]


def test_microbatches_average_their_gradients():
    """Two microbatches give the mean of the two halves' gradients, and
    a batch that does not split into microbatches is refused."""
    cfg, _ = _cfgs(False, microbatch=2)
    params = _port_params()
    x, y = (torch.from_numpy(a) for a in _tokens(3))
    halves = [lm.loss_and_grads(cfg, params, x[j::2], y[j::2]) for j in (0, 1)]
    seen = {}

    def update(grads, state, p):
        seen["grads"] = grads
        return p, state

    _, _, loss = lm.make_train_step(cfg, optim.Optimizer(init=None, update=update))(
        params, None, x, y)
    np.testing.assert_allclose(float(loss), (float(halves[0][0]) + float(halves[1][0])) / 2,
                               rtol=1e-6)
    for name in LEAVES:
        np.testing.assert_allclose(
            _flat(seen["grads"])[name],
            (_flat(halves[0][1])[name] + _flat(halves[1][1])[name]) / 2, rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="not a multiple"):  # 5 rows in microbatches of 2
        lm.make_train_step(cfg, optim.adam(LR))(
            params, optim.adam(LR).init(params), torch.cat([x, x[:1]]), torch.cat([y, y[:1]]))


@pytest.mark.parametrize("after", [1, 2])
def test_bf16_trajectory_holds_dtypes_and_values(after):
    """bf16 parameters: the reference's Adam promotes them to fp32 in
    their first update, its moments follow at the second."""
    want = _jax_trajectory(0, "bfloat16", 2)[after - 1]
    got = _port_trajectory(0, "bfloat16", after)[-1]
    assert got["dtypes"] == want["dtypes"]
    p_dt, m_dt, v_dt = got["dtypes"]
    assert set(p_dt.values()) == {"float32"}
    assert set(m_dt.values()) == set(v_dt.values()) == {"bfloat16" if after == 1 else "float32"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    for name in LEAVES:
        a, b = got["params"][name], want["params"][name]
        diff = np.abs(a - b)
        assert diff.max() <= 2 * (1 + 2**-6) * LR * after, name
        assert (diff > LR / 2).mean() <= 0.02, name
        for mom in ("m", "v"):
            a, b = got[mom][name], want[mom][name]
            assert np.linalg.norm(a - b) <= 3e-2 * np.linalg.norm(b), f"{mom} {name}"
