"""The port's SASRec user tower (`repro_torch.models.recsys`) against the
JAX reference at SMOKE_CONFIG width (embed 50, 2 blocks, 1 head, seq
16), on the CPU, with the reference's weights carried across by
`repro_torch.convert`. Histories hold -1 holes in the middle (the
serving CLI's payloads) and one row is all -1. Tolerance 1e-5 (fp32
matmuls summed in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import recsys_params_from_numpy  # noqa: E402
from repro_torch.models import layers, recsys  # noqa: E402

CFG = get_arch("sasrec").SMOKE_CONFIG
JCFG = jax_get_arch("sasrec").SMOKE_CONFIG


def _params(seed: int):
    jparams = jax_recsys.init_params(JCFG, jax.random.PRNGKey(seed))
    return jparams, recsys_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _hists(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = rng.integers(-1, CFG.item_vocab, (n, CFG.seq_len)).astype(np.int32)
    h[rng.random(h.shape) < 0.3] = -1  # holes in the middle
    h[0] = -1  # an empty history
    h[1, -4:] = -1  # trailing padding
    return h


def test_configs_match_reference():
    assert CFG == type(CFG)(**vars(JCFG))
    assert get_arch("sasrec").CONFIG == type(CFG)(
        **vars(jax_get_arch("sasrec").CONFIG)
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_sasrec_user_vector_matches_reference(seed):
    jparams, params = _params(seed)
    hist = _hists(12, seed)
    ref = np.asarray(jax_recsys.sasrec_user_vector(JCFG, jparams, jnp.asarray(hist)))
    out = recsys.sasrec_user_vector(CFG, params, torch.from_numpy(hist))
    assert out.shape == (12, CFG.embed_dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_last_position_is_count_minus_one_not_last_valid_index():
    """With a hole, the reference reads position count(hist >= 0) - 1,
    which here is a hole (-1) position; the port must read the same."""
    jparams, params = _params(0)
    hist = np.full((1, CFG.seq_len), -1, np.int32)
    hist[0, [0, 5, 9]] = [3, 7, 11]  # count 3 -> position 2, not 9
    ref = np.asarray(jax_recsys.sasrec_user_vector(JCFG, jparams, jnp.asarray(hist)))
    out = recsys.sasrec_user_vector(CFG, params, torch.from_numpy(hist)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 50)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(50).astype(np.float32)
    ref = np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    out = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_sasrec_init_has_reference_layout():
    """The port's own init: the reference's tree, shapes and zero gains."""
    jparams, _ = _params(0)
    gen = torch.Generator().manual_seed(0)
    params = recsys.init_params(CFG, gen, "cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == jshapes
    assert all((b["ln1"] == 0).all() and (b["ln2"] == 0).all() for b in params["blocks"])
    std = float(params["items"].std())
    assert abs(std - 1 / CFG.embed_dim**0.5) < 0.01


def test_other_archs_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="graphcast"):
        get_arch("graphcast")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
