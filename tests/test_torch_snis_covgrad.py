"""The port's fused covgrad ops (`repro_torch.kernels.snis_covgrad`)
against the JAX reference's, on the CPU.

The port's wrappers run their plain PyTorch versions here; the reference
runs its Pallas kernels in interpret mode, per-sample (TS = 1) and tiled
(TS = 8, and TS = 5, which does not divide S = 24). Inputs have masked
slots, a row with every slot masked, and (for the backward) a NaN
coefficient on a dead lane. Tolerances: scores, g, wbar and grad_h
within rtol 1e-5 / atol 1e-6 (fp32 sums taken in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.snis_covgrad import ops as jops  # noqa: E402
from repro_torch.constants import LOG_Q_PAD  # noqa: E402
from repro_torch.kernels.snis_covgrad import kernel, ops  # noqa: E402
from repro_torch.kernels.snis_covgrad import (  # noqa: E402
    resolve_sample_tile,
    snis_covgrad_bwd,
    snis_covgrad_fused,
    snis_scores_fused,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _problem(b=4, s=24, l=16, p=300, seed=0):
    """(h, beta, actions, log_q, rewards) with masked slots in row 0 and
    every slot of the last row masked."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, l)).astype(np.float32)
    beta = (0.3 * rng.standard_normal((p, l))).astype(np.float32)
    actions = rng.integers(0, p, (b, s)).astype(np.int32)
    actions[0, ::3] = -1
    actions[-1] = -1
    log_q = (rng.standard_normal((b, s)) - 5.0).astype(np.float32)
    log_q = np.where(actions >= 0, log_q, np.float32(LOG_Q_PAD)).astype(np.float32)
    rewards = (rng.random((b, s)) < 0.3).astype(np.float32) * (actions >= 0)
    return h, beta, actions, log_q, rewards


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("sample_tile", [1, 8, 5])
def test_covgrad_fused_matches_reference(sample_tile):
    args = _problem(seed=sample_tile)
    jg, jw, js = jops.snis_covgrad_fused(
        *map(jnp.asarray, args), interpret=True, sample_tile=sample_tile
    )
    g, w, s = snis_covgrad_fused(*_t(*args), sample_tile=sample_tile)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    # a fully masked row: exactly zero gradient and weights
    assert (g[-1] == 0).all() and (w[-1] == 0).all()
    assert (w[0].numpy()[args[2][0] < 0] == 0).all()


@pytest.mark.parametrize("sample_tile", [1, 8, 5])
def test_scores_fused_matches_reference(sample_tile):
    args = _problem(seed=10 + sample_tile)
    js = jops.snis_scores_fused(*map(jnp.asarray, args), interpret=True, sample_tile=sample_tile)
    s = snis_scores_fused(*_t(*args), sample_tile=sample_tile)
    assert s.shape == args[2].shape
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    # a masked slot gathers row 0: its score is h . beta_0, not 0
    h, beta, actions = args[:3]
    np.testing.assert_allclose(s[0, 0].item(), float(h[0] @ beta[0]), **TOL)


@pytest.mark.parametrize("sample_tile", [1, 8, 5])
def test_covgrad_bwd_matches_reference(sample_tile):
    h, beta, actions, _, _ = _problem(seed=20 + sample_tile)
    coeff = np.random.default_rng(sample_tile).standard_normal(actions.shape).astype(np.float32)
    coeff[actions < 0] = np.nan  # a dead lane adds nothing, whatever its coefficient
    jgh = jops.snis_covgrad_bwd(
        jnp.asarray(coeff), jnp.asarray(actions), jnp.asarray(beta),
        interpret=True, sample_tile=sample_tile,
    )
    gh = snis_covgrad_bwd(*_t(coeff, actions, beta), sample_tile=sample_tile)
    assert torch.isfinite(gh).all()
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), **TOL)
    assert (gh[-1] == 0).all()


def test_tile_rule_is_the_reference_rule():
    for ts, s in [(0, 24), (1, 24), (8, 24), (5, 24), (100, 24), (8, 1)]:
        assert resolve_sample_tile(ts, s) == jops.resolve_sample_tile(ts, s)


def test_cpu_tensors_take_the_plain_versions():
    h, beta, actions, log_q, rewards = _t(*_problem())
    before = (ops._kernel.snis_fwd_cuda.launches, ops._kernel.snis_bwd_cuda.launches,
              ops._ref.snis_fwd_ref.calls, ops._ref.snis_bwd_ref.calls)
    snis_scores_fused(h, beta, actions, log_q, rewards)
    snis_covgrad_bwd(rewards, actions, beta)
    after = (ops._kernel.snis_fwd_cuda.launches, ops._kernel.snis_bwd_cuda.launches,
             ops._ref.snis_fwd_ref.calls, ops._ref.snis_bwd_ref.calls)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)


@pytest.mark.parametrize("b,s", [(32, 1000), (4, 24), (1, 1), (512, 1000)])
def test_splits_cover_the_samples(b, s):
    """S is cut into chunks of whole 32-sample rounds covering every
    sample once, with about four blocks per SM at small B."""
    splits, chunk = kernel.splits_for(b, s, 132)
    assert chunk % 32 == 0 and (splits - 1) * chunk < s <= splits * chunk
    assert b * splits >= min(3 * 132, b * -(-s // 32))
