"""Edge cases of the port's `ivf_topk` against the JAX reference's, on
the CPU: exhaustive probing, rows short of K candidates, and a non-empty
delta pass. Same set-up and tolerances as `test_torch_ivf_topk.py`.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_common import assert_topk_equal, data, jax_index, to_port  # noqa: E402

from repro.kernels.ivf_topk import ivf_topk as jax_ivf_topk  # noqa: E402
from repro.mips import exact as jax_exact  # noqa: E402
from repro_torch.kernels.ivf_topk import ivf_topk  # noqa: E402


def test_ivf_topk_exhaustive_probe_equals_exact():
    """Probing every cluster makes the candidate set the whole catalog."""
    items, jindex = jax_index(512, 16, 16, seed=0, key=1, cap_tile=16)
    _, q = data(512, 16, 6, seed=0)
    out = ivf_topk(torch.from_numpy(q), to_port(jindex), 48, n_probe=16)
    assert_topk_equal(
        out, jax_exact.topk_exact(jnp.asarray(q), jnp.asarray(items), 48)
    )
    ref = jax_ivf_topk(
        jnp.asarray(q), jindex, 48, n_probe=16, cap_tile=16, interpret=True
    )
    assert_topk_equal(out, ref)


def test_ivf_topk_short_candidates_backfill():
    """k beyond the probed candidate count back-fills (NEG_INF, -1), as
    the reference kernel does."""
    _, jindex = jax_index(100, 8, 8, seed=1, key=2)
    _, q = data(100, 8, 3, seed=1)
    ref = jax_ivf_topk(jnp.asarray(q), jindex, 96, n_probe=1, interpret=True)
    out = ivf_topk(torch.from_numpy(q), to_port(jindex), 96, n_probe=1)
    assert_topk_equal(out, ref)
    ids = out.indices.numpy()
    assert (ids[:, -1] == -1).all()
    assert (out.scores.numpy()[:, -1] == np.float32(-3e38)).all()
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


@pytest.mark.parametrize("dcap", [8, 5])
def test_ivf_topk_delta_pass_matches_reference(dcap):
    """A non-empty delta pass (new ids in the append buffers, some slots
    dead) probed with the main lists' probe ids and merged."""
    p, l, c, b, k = 400, 16, 8, 4, 24
    _, jindex = jax_index(p, l, c, seed=4, key=4, cap_tile=16)
    _, q = data(p, l, b, seed=dcap)
    rng = np.random.default_rng(100 + dcap)
    delta_lists = (p + np.arange(c * dcap, dtype=np.int32)).reshape(c, dcap)
    delta_lists[rng.random((c, dcap)) < 0.3] = -1
    delta_embs = 2.0 * rng.standard_normal((c, dcap, l)).astype(np.float32)
    delta_embs[delta_lists < 0] = 0.0
    ref = jax_ivf_topk(
        jnp.asarray(q), jindex, k, n_probe=3, cap_tile=16, interpret=True,
        delta=(jnp.asarray(delta_lists), jnp.asarray(delta_embs)),
    )
    assert (np.asarray(ref.indices) >= p).any()  # the delta pass contributes
    out = ivf_topk(
        torch.from_numpy(q), to_port(jindex), k, n_probe=3,
        delta=(torch.from_numpy(delta_lists), torch.from_numpy(delta_embs)),
    )
    assert_topk_equal(out, ref)
