"""The port's fused covgrad ops (`repro_torch.kernels.snis_covgrad`)
against the JAX reference's, on the CPU.

The port's wrappers run their plain PyTorch versions here; the reference
runs its Pallas kernels in interpret mode, per-sample (TS = 1) and tiled
(TS = 8, and TS = 5, which does not divide S = 24). Inputs have masked
slots, a row with every slot masked, and (for the backward) a NaN
coefficient on a dead lane, at L 16 and at the widths that the card's
wide path takes (L 18 and 50, not multiples of 4; L 260, over 256).
Tolerances: scores, g, wbar and grad_h within rtol 1e-5 / atol 1e-6
(fp32 sums taken in another order).
"""
import inspect

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


@pytest.mark.parametrize("l", [18, 50, 260])
def test_covgrad_any_width_matches_reference(l):
    args = _problem(l=l, seed=30 + l)
    jg, jw, js = jops.snis_covgrad_fused(*map(jnp.asarray, args), interpret=True, sample_tile=8)
    g, w, s = snis_covgrad_fused(*_t(*args), sample_tile=8)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    assert (g[-1] == 0).all() and (w[-1] == 0).all()
    js = jops.snis_scores_fused(*map(jnp.asarray, args), interpret=True, sample_tile=8)
    np.testing.assert_allclose(snis_scores_fused(*_t(*args)).numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("l", [18, 50, 260])
def test_covgrad_bwd_any_width_matches_reference(l):
    h, beta, actions, _, _ = _problem(l=l, seed=40 + l)
    coeff = np.random.default_rng(l).standard_normal(actions.shape).astype(np.float32)
    coeff[actions < 0] = np.nan
    jgh = jops.snis_covgrad_bwd(
        jnp.asarray(coeff), jnp.asarray(actions), jnp.asarray(beta), interpret=True, sample_tile=8
    )
    gh = snis_covgrad_bwd(*_t(coeff, actions, beta), sample_tile=8)
    assert gh.shape == (actions.shape[0], l) and torch.isfinite(gh).all()
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), **TOL)
    assert (gh[-1] == 0).all()


def test_cuda_wrappers_take_any_width():
    """The wrappers no longer refuse an L that the reference takes: no
    width check is left in them or in the libraries they bind (that the
    kernels compute every L right is `chip_smoke.py`'s check on the
    card, at L 18, 50 and 260)."""
    assert not hasattr(kernel, "_check_dim")
    for fn in (kernel.snis_fwd_cuda, kernel.snis_bwd_cuda):
        src = inspect.getsource(fn)
        assert "max_dim" not in src and "% 4" not in src
    for path in (kernel.FWD_SOURCE, kernel.BWD_SOURCE):
        assert "max_dim" not in path.read_text()


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


@pytest.mark.parametrize("b,s", [(32, 1000), (4, 24), (1, 1), (512, 1000), (1, 100_000), (264, 7)])
@pytest.mark.parametrize("l", [100, 16, 128, 200, 256, 18, 260])
def test_splits_cover_the_samples(b, s, l):
    """The forward cuts S into chunks of whole passes of its block (the
    samples whose rows are in flight at once; 32-sample rounds in the wide
    path) covering every sample once, with at least two blocks per SM at
    small B where S allows (three for the 32-sample rounds, as before the
    passes); at the training shape one pass of 96 a block, 352 blocks."""
    step = kernel.fwd_pass(l)
    splits, chunk = kernel.splits_for(b, s, 132, multiple=step)
    assert chunk % step == 0 and (splits - 1) * chunk < s <= splits * chunk
    per_sm = 3 if step == 32 else 2
    assert b * splits >= min(per_sm * 132, b * -(-s // step))
    if (b, s, l) == (32, 1000, 100):
        assert (splits, chunk) == (11, 96)


@pytest.mark.parametrize("l", range(4, 257, 4))
def test_fwd_lanes_leave_fewer_load_slots_idle(l):
    """The forward's register layout gives a sample `fwd_lanes(L)` lanes of
    at most 8 16-byte words each, at most eight samples a warp, and
    leaves no more of a warp's load slots idle than the first design's 8
    lanes a sample (5 lanes of 5 words at L 100: 150 of 160 slots busy,
    not 100 of 128); any other L takes the wide path (0)."""
    words = l // 4
    lanes = kernel.fwd_lanes(l)
    nv = -(-words // lanes)
    assert 4 <= lanes <= 32 and nv <= 8 and lanes * nv >= words
    busy = (32 // lanes) * words / (32 * nv)
    assert busy >= (32 // 8) * words / (32 * -(-words // 8))
    assert kernel.fwd_pass(l) == 8 * (32 // lanes) * 2
    if l == 100:
        assert (lanes, nv, kernel.fwd_pass(l)) == (5, 5, 96) and busy == 150 / 160
    for wide in (l + 2, l + 256):
        assert kernel.fwd_lanes(wide) == 0 and kernel.fwd_pass(wide) == 32


def test_bwd_is_one_launch_on_the_shared_ticket_counters(monkeypatch):
    """The backward launches one kernel a call (no finalize kernel: the last
    block of a row adds its partials) on the ticket counters that
    `_launch` keeps for K7 and the backward alike: one zeroed int32 [B]
    buffer per (device, stream, B), another per CUDA-graph capture; both
    wrappers ask their library which capture is under way."""
    import re

    from repro_torch.kernels import _launch
    from repro_torch.kernels.ivf_topk import kernel as ivf_kernel

    src = kernel.BWD_SOURCE.read_text()
    assert "snis_bwd_finalize" not in src
    for fn in ("launch_nv", "launch_wide"):
        body = src[src.index(f"cudaError_t {fn}("):]
        body = body[:body.index("\n}\n")]
        assert len(re.findall(r"<<<", body)) == 1, fn
    assert "snis_bwd_capture_id" in src
    for wrapper, capture in ((kernel.snis_bwd_cuda, "snis_bwd_capture_id"),
                             (ivf_kernel.ivf_probe_topk_cuda, "ivf_topk_capture_id")):
        code = inspect.getsource(wrapper)
        assert "_launch.ticket_counters(" in code and capture in code
    assert not hasattr(ivf_kernel, "ticket_counters")

    monkeypatch.setattr(_launch, "_COUNTERS", {})
    dev = torch.device("cpu")
    eager = _launch.ticket_counters(dev, 7, 32)
    assert eager.dtype == torch.int32 and eager.shape == (32,) and not eager.any()
    assert _launch.ticket_counters(dev, 7, 32) is eager  # K7 and K3/K4 on one stream
    captured = [_launch.ticket_counters(dev, 7, 32, capture=c) for c in (3, 4)]
    assert captured[0] is not captured[1] and all(c is not eager for c in captured)
    assert _launch.ticket_counters(dev, 7, 32, capture=3) is captured[0]
    assert _launch.ticket_counters(dev, 8, 32) is not eager
    assert len(_launch._COUNTERS) == 4


@pytest.mark.parametrize("b,s", [(32, 1000), (4, 24), (1, 1), (512, 1000), (1, 100_000), (264, 7)])
@pytest.mark.parametrize("l", [100, 256, 18, 260])
def test_bwd_splits_cover_the_samples(b, s, l):
    """The backward cuts S into chunks of whole 32-sample rounds covering
    every sample once: about two blocks per SM where the samples allow in
    the register layout (at the training shape 8 chunks of 128), four in
    the wide path (L not a multiple of 4, or over 256), as the forward."""
    per_sm = kernel.bwd_per_sm(l)
    assert per_sm == (2 if l in (100, 256) else 4)
    splits, chunk = kernel.splits_for(b, s, 132, per_sm)
    assert chunk % 32 == 0 and (splits - 1) * chunk < s <= splits * chunk
    assert b * splits >= min(132, b * -(-s // 32))
    if per_sm == 4:
        assert (splits, chunk) == kernel.splits_for(b, s, 132)
    else:
        assert b * splits <= max(b, 2 * 132 + b)
    if (b, s, l) == (32, 1000, 100):
        assert (splits, chunk) == (8, 128)
