"""The port's MoE LMs in training: `repro_torch.models.lm.make_train_step`
with the port's Adam against the JAX reference's, on the CPU, at OLMoE's
and Arctic's SMOKE_CONFIGs (the weights, tokens and helpers of
`test_torch_moe.py`), and `repro_torch.convert` over MoE trees and Adam
state with bf16 moments.

Tolerances: loss rtol 1e-5; moments rtol 1e-4 / atol 1e-5 times the
leaf's max |moment|; parameters rtol 1e-5 / atol 1e-6 on all but 0.1 %
of each leaf's entries, every entry within 2e-2 lr of the reference, but
for entries whose first moment is under 1e-4 of the leaf's largest, held
within 2 lr: Adam's g / (|g| + eps) turns an fp32 difference in a
gradient entry near 0 into an update difference of up to ~lr (an
expert's weight that few tokens reach has such entries: one at |m| 4e-9
against a largest 1e-2 moved 4.8e-2 lr apart with 2 microbatches; an
Arctic embedding entry at |m| 5e-9, 9.1e-2 lr). Each step is held from
the reference's state before it.
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
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import adam_state_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_moe import (  # noqa: E402
    MOE_ARCHS, _cfgs, _flat, _jax_params, _port_params, _tokens,
)

LR = 1e-3


@functools.cache
def _jax_steps(arch: str, microbatch: int, steps: int, moments: str | None):
    """[(what a step starts from: (params, Adam state) as numpy trees,
    what it gives: `_record`)] for ``steps`` reference Adam steps."""
    _, jcfg = _cfgs(arch, microbatch=microbatch)
    opt = joptim.adam(LR, moments_dtype=moments)
    params = _jax_params(arch)
    state = opt.init(params)
    step = jax.jit(jax_lm.make_train_step(jcfg, opt))
    out = []
    for i in range(steps):
        start = jax.tree.map(np.asarray, (params, state))
        x, y = (jnp.asarray(a) for a in _tokens(10 + i, jcfg.vocab_size))
        params, state, loss = step(params, state, x, y)
        out.append((start, _record(loss, params, state)))
    return out


def _record(loss, params, state) -> dict:
    return dict(loss=float(loss), params=_flat(params), m=_flat(state["m"]),
                v=_flat(state["v"]), m_dtype=str(state["m"]["embed"].dtype).replace("torch.", ""))


def _port_steps(arch: str, microbatch: int, steps, start=None, moments=None) -> list:
    """The port's records after each of ``steps`` Adam steps (an int, or
    the step indices to take), from ``start`` (numpy (params, state)
    trees) or from the reference's initial weights and a fresh state."""
    cfg, _ = _cfgs(arch, microbatch=microbatch)
    opt = optim.adam(LR, moments_dtype=moments)
    if start is None:
        params = _port_params(arch)
        state = opt.init(params)
    else:
        params, state = lm_params_from_numpy(start[0]), adam_state_from_numpy(start[1])
    step = lm.make_train_step(cfg, opt)
    out = []
    for i in range(steps) if isinstance(steps, int) else steps:
        x, y = (torch.from_numpy(a) for a in _tokens(10 + i, cfg.vocab_size))
        params, state, loss = step(params, state, x, y)
        out.append(_record(loss, params, state))
    return out


def _assert_step_close(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert sorted(got["params"]) == sorted(want["params"])
    assert got["m_dtype"] == want["m_dtype"]
    for name, b in want["params"].items():
        diff = np.abs(got["params"][name] - b)
        assert (diff > 1e-6 + 1e-5 * np.abs(b)).mean() <= 1e-3, name
        m = np.abs(want["m"][name])
        near0 = m < 1e-4 * m.max()
        assert diff[~near0].max(initial=0.0) <= 2e-2 * LR, name
        assert diff[near0].max(initial=0.0) <= 2 * LR, name
        for mom in ("m", "v"):
            w = want[mom][name]
            np.testing.assert_allclose(got[mom][name], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{mom} {name}")


@pytest.mark.parametrize("microbatch", [0, 2], ids=["whole", "micro2"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(arch, microbatch):
    """One Adam step on batch 4; microbatch 2 routes each microbatch's
    2 x S tokens at its own capacity, as the reference's scan does."""
    _assert_step_close(_port_steps(arch, microbatch, 1)[0],
                       _jax_steps(arch, microbatch, 1, None)[0][1])


def test_arctic_trajectory_with_bf16_moments():
    """Arctic's memory policy: Adam's moments start in bf16. The
    reference's initial state is carried across by `convert` bit for bit.
    3 steps: the port's own trajectory keeps the reference's losses and
    dtypes (the moments become fp32 at the first update in both: bf16
    moments meet fp32 gradients), and each step, taken from the
    reference's state before it, gives the reference's parameters and
    moments (a free trajectory carries step 1's near-0 entries, see the
    module's tolerances, into later gradients)."""
    ref = _jax_steps("arctic-480b", 0, 3, "bfloat16")
    state0 = adam_state_from_numpy(ref[0][0][1])
    assert state0["m"]["layers"]["we_gate"].dtype == torch.bfloat16
    assert state0["v"]["embed"].dtype == torch.bfloat16 and int(state0["step"]) == 0
    free = _port_steps("arctic-480b", 0, 3, start=ref[0][0], moments=torch.bfloat16)
    assert [g["m_dtype"] for g in free] == [w["m_dtype"] for _, w in ref] == ["float32"] * 3
    np.testing.assert_allclose([g["loss"] for g in free], [w["loss"] for _, w in ref], rtol=1e-5)
    for i, (start, want) in enumerate(ref):
        _assert_step_close(_port_steps("arctic-480b", 0, [i], start=start)[0], want)


def test_convert_carries_moe_trees_bit_for_bit():
    """`lm_params_from_numpy` is generic over the layer leaves: an MoE tree
    (and a bf16 one) comes across with the reference's names, shapes,
    dtypes and bits; the port's own `init_params` has the reference's
    shapes."""
    for arch in MOE_ARCHS:
        _, jcfg = _cfgs(arch, dtype="bfloat16")
        jparams = jax.tree.map(np.asarray, jax_lm.init_params(jcfg, jax.random.PRNGKey(3)))
        port = lm_params_from_numpy(jparams)
        for name, a in jparams["layers"].items():
            t = port["layers"][name]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, name
            assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16)), name
        cfg = get_arch(arch).SMOKE_CONFIG
        mine = lm.init_params(cfg, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == {
            k: a.shape for k, a in _jax_params(arch)["layers"].items()}
