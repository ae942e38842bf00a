"""The port's recsys training (`repro_torch.models.recsys.bce_loss` and
`make_train_step`) against the JAX reference at SMOKE_CONFIG, on the
CPU, with the reference's weights carried across by
`recsys_params_from_numpy` and batches drawn from numpy with a seed, as
the reference's launcher draws them.

* BCE (DIN, DIEN, Wide&Deep): 1- and 3-step Adam(1e-3) trajectories.
  The port's own trajectory keeps the reference's loss at every step
  (rtol 1e-5 / atol 1e-6); each step, taken from the reference's state
  before it (`convert`), gives its parameters within rtol 1e-5 / atol
  1e-6 and its first moments within rtol 1e-5 / atol 1e-6 times the
  leaf's largest, but for parameter entries whose first moment is under
  1e-4 of the leaf's largest, held within 2 lr: Adam's g / (|g| + eps)
  turns an fp32 difference in a gradient entry near 0 into an update
  difference of up to ~lr (`chip_smoke.theta_gate`'s rule; one entry of
  Wide&Deep's shared hashed table, 1 of 64,000, moved 1.8e-3 lr apart).
The FOPO objective, the sharded retriever mode, the flagship reward test
and the train CLI are in `test_torch_recsys_fopo.py`, which shares this
file's set-up.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import adam_state_from_numpy, recsys_params_from_numpy  # noqa: E402
from repro_torch.models import recsys  # noqa: E402

B, LR = 64, 1e-3


@functools.cache
def _setup(arch: str):
    """(cfg, the reference's cfg, its params); read only."""
    cfg, jcfg = get_arch(arch).SMOKE_CONFIG, jax_get_arch(arch).SMOKE_CONFIG
    return cfg, jcfg, jax_recsys.init_params(jcfg, jax.random.PRNGKey(0))


def _port_params(arch: str):
    return recsys_params_from_numpy(jax.tree.map(np.asarray, _setup(arch)[2]))


def _batches(cfg, steps: int, objective: str) -> list[dict]:
    """The reference launcher's batches of 64, in its order of draws."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        if cfg.kind == "wide_deep":
            out.append({
                "sparse": rng.integers(0, 10**6, (B, cfg.n_sparse)).astype(np.int32),
                "dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                "label": (rng.random(B) < 0.3).astype(np.float32),
            })
        elif objective == "fopo":
            out.append({
                "hist": rng.integers(-1, cfg.item_vocab, (B, cfg.seq_len)).astype(np.int32),
                "positives": rng.integers(0, cfg.item_vocab, (B, 4)).astype(np.int32),
            })
        else:
            out.append({
                "hist": rng.integers(-1, cfg.item_vocab, (B, cfg.seq_len)).astype(np.int32),
                "target": rng.integers(0, cfg.item_vocab, (B,)).astype(np.int32),
                "label": (rng.random(B) < 0.3).astype(np.float32),
            })
    return out


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree) -> list[np.ndarray]:
    """A params tree (JAX or torch) as fp32 numpy leaves, dicts in the
    order of their sorted keys (JAX's), lists by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree, np.float32)]


# -- BCE --------------------------------------------------------------------------

@functools.cache
def _jax_bce(arch: str, steps: int):
    """[(the (params, Adam state) a step starts from, as numpy trees; its
    loss; the parameters' and the first moment's leaves after it)]."""
    _, jcfg, params = _setup(arch)
    opt = joptim.adam(LR)
    st = opt.init(params)
    step = jax.jit(jax_recsys.make_train_step(jcfg, opt))
    out = []
    for i, batch in enumerate(_batches(jcfg, steps, "bce")):
        start = jax.tree.map(np.asarray, (params, st))
        params, st, loss = step(params, st, _j(batch), jax.random.PRNGKey(i))
        out.append((start, float(loss), _leaves(params), _leaves(st["m"])))
    return out


def _assert_adam_step_close(params, state, want_p, want_m):
    got_p, got_m = _leaves(params), _leaves(state["m"])
    assert len(got_p) == len(want_p) == len(got_m) == len(want_m)
    for j, (a, b, ma, mb) in enumerate(zip(got_p, want_p, got_m, want_m)):
        np.testing.assert_allclose(ma, mb, rtol=1e-5, atol=1e-6 * np.abs(mb).max(),
                                   err_msg=f"m leaf {j}")
        near0 = np.abs(mb) < 1e-4 * np.abs(mb).max()
        np.testing.assert_allclose(a[~near0], b[~near0], rtol=1e-5, atol=1e-6,
                                   err_msg=f"leaf {j}")
        assert np.abs(a - b)[near0].max(initial=0.0) <= 2 * LR, f"leaf {j}"


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["din", "dien", "wide-deep"])
def test_bce_trajectory_matches_reference(arch, steps):
    cfg = _setup(arch)[0]
    opt = optim.adam(LR)
    step = recsys.make_train_step(cfg, opt)
    want = _jax_bce(arch, 3)
    batches = _batches(cfg, steps, "bce")
    params = _port_params(arch)
    st = opt.init(params)
    for i, batch in enumerate(batches):
        params, st, loss = step(params, st, _t(batch), i)
        np.testing.assert_allclose(float(loss), want[i][1], rtol=1e-5, atol=1e-6)
    for i, batch in enumerate(batches):
        (p0, s0), loss, want_p, want_m = want[i]
        p, s, _ = step(recsys_params_from_numpy(p0), adam_state_from_numpy(s0), _t(batch), i)
        _assert_adam_step_close(p, s, want_p, want_m)


def test_bce_loss_is_the_stable_form():
    """`bce_loss` on a batch against the reference's."""
    cfg, jcfg, jparams = _setup("din")
    batch = _batches(cfg, 1, "bce")[0]
    want = float(jax_recsys.bce_loss(jcfg, jparams, _j(batch)))
    got = float(recsys.bce_loss(cfg, _port_params("din"), _t(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
