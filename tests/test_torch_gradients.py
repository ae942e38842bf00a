"""The port's SNIS, rewards, proposals, policy and gradient estimators
against the JAX reference's, on the CPU.

The same numpy inputs go through both packages. Tolerances: rtol 1e-5 /
atol 1e-6 on values and gradients (fp32 sums in another order), except
`MixtureProposal.log_prob`, held within 1e-6 (rtol 1e-6 beside it: an
ulp of fp32 at |log q| ~ 14 is 9.5e-7). The fused path runs the
reference's Pallas kernels in interpret mode and the port's plain
versions (its kernels run only on the card, see `chip_smoke.py`).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import gradients as jgrad  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import proposals as jprop  # noqa: E402
from repro.core import rewards as jrew  # noqa: E402
from repro.core import snis as jsnis  # noqa: E402
from repro_torch.constants import LOG_Q_PAD  # noqa: E402
from repro_torch.core import gradients, policy, proposals, rewards, snis  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _sampled(b=5, s=32, l=12, p=200, seed=0):
    """(x, w, beta, actions, log_q, rewards) with masked slots in row 0
    and a fully masked last row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l)).astype(np.float32)
    w = (rng.standard_normal((l, l)) / np.sqrt(l)).astype(np.float32)
    beta = (0.5 * rng.standard_normal((p, l))).astype(np.float32)
    actions = rng.integers(0, p, (b, s)).astype(np.int32)
    actions[0, ::4] = -1
    actions[-1] = -1
    log_q = np.where(actions >= 0, rng.standard_normal((b, s)) - 5.0, LOG_Q_PAD)
    rew = ((rng.random((b, s)) < 0.3) * (actions >= 0)).astype(np.float32)
    return x, w, beta, actions, log_q.astype(np.float32), rew


# -- SNIS -------------------------------------------------------------------

def test_snis_pieces_match_reference():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((4, 20)).astype(np.float32)
    log_q = (rng.standard_normal((4, 20)) - 3).astype(np.float32)
    valid = rng.random((4, 20)) < 0.8
    valid[-1] = False  # a dead row: weights 0, ESS 0
    rew = rng.random((4, 20)).astype(np.float32)
    vals = rng.standard_normal((4, 20, 3)).astype(np.float32)
    jw = jsnis.snis_weights(jnp.asarray(scores), jnp.asarray(log_q), jnp.asarray(valid))
    w = snis.snis_weights(_t(scores), _t(log_q), _t(valid))
    for got, want in zip(w, jw):
        _close(got, want)
    assert w.ess[-1] == 0
    _close(snis.snis_expectation(w.wbar, _t(rew)), jsnis.snis_expectation(jw.wbar, rew))
    _close(snis.snis_expectation(w.wbar, _t(vals)), jsnis.snis_expectation(jw.wbar, vals))
    _close(snis.snis_covariance_coefficients(w.wbar, _t(rew)),
           jsnis.snis_covariance_coefficients(jw.wbar, rew))
    jd, d = jsnis.snis_diagnostics(jw.wbar, rew), snis.snis_diagnostics(w.wbar, _t(rew))
    assert tuple(d) == snis.DIAGNOSTIC_KEYS == jsnis.DIAGNOSTIC_KEYS
    for k in snis.DIAGNOSTIC_KEYS:
        _close(d[k], jd[k])


# -- rewards ----------------------------------------------------------------

def test_rewards_match_reference():
    rng = np.random.default_rng(2)
    b, s, p, l = 4, 10, 30, 6
    actions = rng.integers(0, p, (b, s)).astype(np.int32)
    positives = rng.integers(-1, p, (b, 5)).astype(np.int32)
    positives[:, 0] = actions[:, 0]  # at least one hit per row
    _close(rewards.make_session_reward(_t(positives))(_t(actions)),
           jrew.make_session_reward(jnp.asarray(positives))(jnp.asarray(actions)))
    la = actions[:, 1].copy()
    prop = rng.uniform(0.01, 0.5, b).astype(np.float32)
    rr = rng.random(b).astype(np.float32)
    items = rng.standard_normal((p, l)).astype(np.float32)
    users = rng.standard_normal((b, l)).astype(np.float32)
    jlog = jrew.LoggedFeedback(jnp.asarray(la), jnp.asarray(prop), jnp.asarray(rr))
    log = rewards.LoggedFeedback(_t(la), _t(prop), _t(rr))
    for tau in (0.0, 0.2):
        _close(rewards.make_ips_reward(log, tau)(_t(actions)),
               jrew.make_ips_reward(jlog, tau)(jnp.asarray(actions)))
        jm = jrew.make_dot_reward_model(jnp.asarray(items), jnp.asarray(users), 0.5)
        m = rewards.make_dot_reward_model(_t(items), _t(users), 0.5)
        _close(m(_t(actions)), jm(jnp.asarray(actions)))
        _close(rewards.make_dr_reward(log, m, tau)(_t(actions)),
               jrew.make_dr_reward(jlog, jm, tau)(jnp.asarray(actions)))


# -- proposals ----------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.3, 0.8, 1.0, "tensor"])
def test_mixture_log_prob_matches_reference(eps):
    rng = np.random.default_rng(3)
    b, k, p, s = 4, 8, 750_000, 40
    ids = np.stack([rng.permutation(1000)[:k] for _ in range(b)]).astype(np.int32)
    sc = (3 * rng.standard_normal((b, k))).astype(np.float32)
    actions = np.where(rng.random((b, s)) < 0.5, ids[:, rng.integers(0, k, s)],
                       rng.integers(0, p, (b, s))).astype(np.int32)
    j_eps, t_eps = (jnp.float32(0.7), torch.tensor(0.7)) if eps == "tensor" else (eps, eps)
    want = jprop.MixtureProposal(p, j_eps).log_prob(
        jnp.asarray(actions), jnp.asarray(ids), jnp.asarray(sc))
    got = proposals.MixtureProposal(p, t_eps).log_prob(_t(actions), _t(ids), _t(sc))
    _close(got, want, rtol=1e-6, atol=1e-6)
    _close(proposals.UniformProposal(p).log_prob(_t(actions)),
           jprop.UniformProposal(p).log_prob(jnp.asarray(actions)), rtol=1e-6, atol=1e-6)


def test_mixture_sample_is_consistent_with_its_pmf():
    """Draws from a torch.Generator: in range, log q equal to log_prob at
    the draws, slot -1 exactly on uniform-arm draws outside the top-K."""
    rng = np.random.default_rng(4)
    ids = _t(np.stack([rng.permutation(50)[:6] for _ in range(3)]).astype(np.int32))
    sc = _t(rng.standard_normal((3, 6)).astype(np.float32))
    prop = proposals.MixtureProposal(50, torch.tensor(0.4))
    out = prop.sample(torch.Generator().manual_seed(0), ids, sc, 400)
    assert out.actions.dtype == torch.int32 and out.actions.shape == (3, 400)
    assert (out.actions >= 0).all() and (out.actions < 50).all()
    _close(out.log_q, prop.log_prob(out.actions, ids, sc))
    kappa = out.topk_slot >= 0
    # the kappa arm follows softmax(scores) over the top-K
    freq = torch.bincount(out.topk_slot[kappa].long() + 6 * torch.arange(3)[:, None].expand(-1, 400)[kappa],
                          minlength=18).reshape(3, 6).float()
    torch.testing.assert_close(freq / freq.sum(1, keepdim=True), torch.softmax(sc, -1), atol=0.12, rtol=0)
    assert (torch.gather(ids, 1, out.topk_slot.clamp(min=0).long())[kappa] == out.actions[kappa]).all()
    frac_uniform = float((~kappa).float().mean())
    assert 0.3 < frac_uniform < 0.5  # eps = 0.4


def test_adaptive_epsilon_matches_reference():
    for step in (0, 1, 7, 50, 100, 150):
        _close(proposals.adaptive_epsilon(step, 100), jprop.adaptive_epsilon(step, 100))


# -- policy -------------------------------------------------------------------

def test_policy_matches_reference():
    x, w, beta, actions, _, _ = _sampled(seed=5)
    jp = jpol.SoftmaxPolicy(tower=jpol.linear_tower_apply, item_dim=12)
    tp = policy.SoftmaxPolicy(tower=policy.linear_tower_apply, item_dim=12)
    jparams, tparams = {"w": jnp.asarray(w)}, {"w": _t(w)}
    acts = np.maximum(actions, 0)
    _close(tp.user_embedding(tparams, _t(x)), jp.user_embedding(jparams, jnp.asarray(x)))
    _close(tp.scores(tparams, _t(x), _t(beta)), jp.scores(jparams, jnp.asarray(x), jnp.asarray(beta)))
    _close(tp.scores_at(tparams, _t(x), _t(beta), _t(acts)),
           jp.scores_at(jparams, jnp.asarray(x), jnp.asarray(beta), jnp.asarray(acts)))
    _close(tp.log_probs(tparams, _t(x), _t(beta)),
           jp.log_probs(jparams, jnp.asarray(x), jnp.asarray(beta)))
    np.testing.assert_array_equal(
        tp.argmax_action(tparams, _t(x), _t(beta)).numpy(),
        np.asarray(jp.argmax_action(jparams, jnp.asarray(x), jnp.asarray(beta))))
    # the MLP tower, from the reference's weights
    jm = jpol.mlp_tower_init(jax.random.PRNGKey(0), (12, 20, 12))
    tm = {"layers": [{k: _t(v) for k, v in lay.items()} for lay in jm["layers"]]}
    _close(policy.mlp_tower_apply(tm, _t(x)), jpol.mlp_tower_apply(jm, jnp.asarray(x)))
    # the port's own inits: shapes and scales
    g = torch.Generator().manual_seed(0)
    assert policy.linear_tower_init(g, 100, 100)["w"].std().item() == pytest.approx(0.1, rel=0.05)
    lay = policy.mlp_tower_init(g, (12, 20, 12))["layers"]
    assert [tuple(lay_["w"].shape) for lay_ in lay] == [(12, 20), (20, 12)]


def test_policy_sample_follows_pi():
    rng = np.random.default_rng(6)
    beta = _t(rng.standard_normal((8, 4)).astype(np.float32))
    x = _t(rng.standard_normal((2, 4)).astype(np.float32))
    tp = policy.SoftmaxPolicy(tower=policy.linear_tower_apply, item_dim=4)
    params = {"w": torch.eye(4)}
    acts = tp.sample(torch.Generator().manual_seed(1), params, x, beta, 20_000)
    assert acts.shape == (2, 20_000)
    freq = torch.stack([torch.bincount(a, minlength=8) for a in acts]).float() / 20_000
    torch.testing.assert_close(freq, tp.log_probs(params, x, beta).exp(), atol=0.02, rtol=0)


# -- gradient estimators --------------------------------------------------------

def _jpolicy():
    return jpol.SoftmaxPolicy(tower=jpol.linear_tower_apply, item_dim=12)


def _tpolicy():
    return policy.SoftmaxPolicy(tower=policy.linear_tower_apply, item_dim=12)


def test_exact_objective_and_grad_match_reference():
    x, w, beta, _, _, _ = _sampled(seed=7)
    dense = (np.random.default_rng(7).random((5, 200)) < 0.05).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda p: jgrad.exact_objective(
        _jpolicy(), p, jnp.asarray(x), jnp.asarray(beta), jnp.asarray(dense)))({"w": jnp.asarray(w)})
    tw = _t(w).requires_grad_(True)
    tl = gradients.exact_objective(_tpolicy(), {"w": tw}, _t(x), _t(beta), _t(dense))
    tl.backward()
    _close(tl, jl)
    _close(tw.grad, jg["w"])


def test_reinforce_surrogate_matches_reference_on_shared_draws():
    """The same draws (injected in both policies) give the same loss and
    gradient; the draws themselves come from each package's own RNG."""
    x, w, beta, _, _, _ = _sampled(seed=8)
    draws = np.random.default_rng(8).integers(0, 200, (5, 16)).astype(np.int32)
    positives = np.random.default_rng(9).integers(0, 200, (5, 40)).astype(np.int32)

    class JPol(jpol.SoftmaxPolicy):
        def sample(self, key, params, x, beta, num_samples):
            return jnp.asarray(draws)

    class TPol(policy.SoftmaxPolicy):
        def sample(self, generator, params, x, beta, num_samples):
            return _t(draws).long()

    jl, jg = jax.value_and_grad(lambda p: jgrad.reinforce_surrogate(
        JPol(jpol.linear_tower_apply, 12), p, jax.random.PRNGKey(0), jnp.asarray(x),
        jnp.asarray(beta), jrew.make_session_reward(jnp.asarray(positives)), 16,
    ))({"w": jnp.asarray(w)})
    tw = _t(w).requires_grad_(True)
    tl = gradients.reinforce_surrogate(
        TPol(policy.linear_tower_apply, 12), {"w": tw}, torch.Generator(), _t(x), _t(beta),
        rewards.make_session_reward(_t(positives)), 16,
    )
    tl.backward()
    _close(tl, jl)
    _close(tw.grad, jg["w"])


def test_covariance_surrogate_matches_reference():
    x, w, beta, actions, log_q, rew = _sampled(seed=10)
    (jl, jaux), jg = jax.value_and_grad(lambda p: jgrad.covariance_surrogate(
        _jpolicy(), p, jnp.asarray(x), jnp.asarray(beta), jnp.asarray(actions),
        jnp.asarray(log_q), jnp.asarray(rew)), has_aux=True)({"w": jnp.asarray(w)})
    tw = _t(w).requires_grad_(True)
    tl, taux = gradients.covariance_surrogate(
        _tpolicy(), {"w": tw}, _t(x), _t(beta), _t(actions), _t(log_q), _t(rew))
    tl.backward()
    _close(tl, jl)
    _close(tw.grad, jg["w"])
    for k in snis.DIAGNOSTIC_KEYS:
        _close(taux[k], jaux[k])


@pytest.mark.parametrize("sample_tile", [1, 8])
def test_fused_loss_and_grad_match_reference(sample_tile):
    """The port's autograd Function against `jax.value_and_grad` of the
    reference's custom_vjp `fused_covariance_loss`: loss, diagnostics and
    dL/dh; beta gets no gradient in either."""
    x, w, beta, actions, log_q, rew = _sampled(seed=11 + sample_tile)
    h = x @ w
    (jl, jaux), jgh = jax.value_and_grad(lambda hh: jgrad.fused_covariance_loss(
        hh, jnp.asarray(beta), jnp.asarray(actions), jnp.asarray(log_q), jnp.asarray(rew),
        interpret=True, sample_tile=sample_tile), has_aux=True)(jnp.asarray(h))
    th = _t(h).requires_grad_(True)
    tb = _t(beta).requires_grad_(True)
    tl, taux = gradients.fused_covariance_loss(
        th, tb, _t(actions), _t(log_q), _t(rew), sample_tile=sample_tile)
    tl.backward()
    _close(tl, jl)
    _close(th.grad, jgh)
    assert tb.grad is None  # Assumption 1: beta is fixed
    assert (th.grad[-1] == 0).all()  # the fully masked row
    for k in snis.DIAGNOSTIC_KEYS:
        _close(taux[k], jaux[k])


def test_fused_and_unfused_paths_agree():
    x, w, beta, actions, log_q, rew = _sampled(seed=14)
    out = {}
    for fused in (False, True):
        tw = _t(w).requires_grad_(True)
        loss, aux = gradients.covariance_surrogate(
            _tpolicy(), {"w": tw}, _t(x), _t(beta), _t(actions), _t(log_q), _t(rew),
            fused=fused, sample_tile=8)
        loss.backward()
        out[fused] = (loss.detach(), tw.grad, aux)
    torch.testing.assert_close(out[True][0], out[False][0], **TOL)
    torch.testing.assert_close(out[True][1], out[False][1], **TOL)
    for k in snis.DIAGNOSTIC_KEYS:
        torch.testing.assert_close(out[True][2][k], out[False][2][k], **TOL)


def test_policy_helpers_match_reference():
    """`make_linear_policy` / `make_mlp_policy` build the reference's
    policies: the same towers, the same item_dim, the same scores on the
    reference's weights."""
    x, w, beta, _, _, _ = _sampled(seed=15)
    lin_t, lin_j = policy.make_linear_policy(12, 12), jpol.make_linear_policy(12, 12)
    assert lin_t.tower is policy.linear_tower_apply and lin_t.item_dim == lin_j.item_dim == 12
    _close(lin_t.log_probs({"w": _t(w)}, _t(x), _t(beta)),
           lin_j.log_probs({"w": jnp.asarray(w)}, jnp.asarray(x), jnp.asarray(beta)))
    jm = jpol.mlp_tower_init(jax.random.PRNGKey(3), (12, 16, 12))
    tm = {"layers": [{k: _t(v) for k, v in lay.items()} for lay in jm["layers"]]}
    mlp_t, mlp_j = policy.make_mlp_policy(12), jpol.make_mlp_policy(12)
    assert mlp_t.tower is policy.mlp_tower_apply and mlp_t.item_dim == mlp_j.item_dim == 12
    _close(mlp_t.scores(tm, _t(x), _t(beta)), mlp_j.scores(jm, jnp.asarray(x), jnp.asarray(beta)))


@pytest.mark.parametrize("tower", ["linear", "mlp"])
def test_covariance_gradient_dense_reference_matches_reference(tower):
    """The O(P) dense gradient against the reference's and against the
    gradient of `exact_objective` taken directly (the covariance
    identity, Eq. 8, as `tests/test_gradients.py` checks it); a tree
    shaped like the parameters, which it leaves untouched."""
    x, w, beta, _, _, _ = _sampled(seed=16)
    dense = (np.random.default_rng(16).random((5, 200)) < 0.05).astype(np.float32)
    if tower == "linear":
        jparams, tparams = {"w": jnp.asarray(w)}, {"w": _t(w)}
        jp, tp = jpol.make_linear_policy(12, 12), policy.make_linear_policy(12, 12)
    else:
        jparams = jpol.mlp_tower_init(jax.random.PRNGKey(4), (12, 16, 12))
        tparams = {"layers": [{k: _t(v) for k, v in lay.items()} for lay in jparams["layers"]]}
        jp, tp = jpol.make_mlp_policy(12), policy.make_mlp_policy(12)
    args = (_t(x), _t(beta), _t(dense))
    got = gradients.covariance_gradient_dense_reference(tp, tparams, *args)
    want = jgrad.covariance_gradient_dense_reference(
        jp, jparams, jnp.asarray(x), jnp.asarray(beta), jnp.asarray(dense))
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    tree_map(_close, got, jax.tree.map(np.asarray, want))  # leaf by leaf, by name
    # the same as autograd through exact_objective itself
    live = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
    it = iter(live)
    direct = torch.autograd.grad(
        gradients.exact_objective(tp, tree_map(lambda _: next(it), tparams), *args), live)
    for g, d in zip(tree_leaves(got), direct):
        torch.testing.assert_close(g, d, rtol=0, atol=0)
    assert all(not t.requires_grad for t in tree_leaves(tparams))
