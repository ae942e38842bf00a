"""The port's GNN (`repro_torch.models.gnn`) against the reference's
`repro.models.gnn`, on the CPU, at graphcast's SMOKE_CONFIG (3 layers,
d_hidden 32, n_vars 8) over random graphs with padded edges (-1), the
parameters carried across by `repro_torch.convert.gnn_params_from_numpy`.

Tolerances: the forward, the loss and every gradient leaf at rtol 1e-5
with atol 1e-5 times the leaf's largest magnitude (fp32 sums of terms of
both signs taken in another order: the segment sums, the matmuls).
Padded edges and tied maxima are in `test_torch_gnn_edges.py`, training
(the Adam trajectory, the reference's smoke tests) in
`test_torch_gnn_train.py`.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.configs_base import GNNConfig  # noqa: E402
from repro_torch.optim.optimizers import tree_map, value_and_grad  # noqa: E402

D_FEAT, N, E = 12, 40, 200
MODES = {"scan_remat": dict(scan_layers=True, remat=True),
         "scan": dict(scan_layers=True, remat=False),
         "unrolled": dict(scan_layers=False, remat=False)}


def _cfgs(aggregator: str = "sum", mode: str = "scan_remat"):
    """(the port's config, the reference's) at SMOKE_CONFIG."""
    kw = dict(aggregator=aggregator, **MODES[mode])
    return (dataclasses.replace(get_arch("graphcast").SMOKE_CONFIG, **kw),
            dataclasses.replace(jget_arch("graphcast").SMOKE_CONFIG, **kw))


@functools.cache
def _jax_params(seed: int = 0):
    _, jcfg = _cfgs()
    return jgnn.init_params(jcfg, jax.random.PRNGKey(seed), d_feat=D_FEAT)


def _port_params(seed: int = 0):
    return gnn_params_from_numpy(jax.tree.map(np.asarray, _jax_params(seed)))


def _graph(seed: int, n: int = N, e: int = E):
    """(feats, src, dst, targets, mask) as numpy: about 1 edge in 12 is
    padding (-1 in src, dst or both), node 0 gets real edges too."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, D_FEAT)).astype(np.float32)
    src = rng.integers(-1, n, e).astype(np.int32)
    dst = rng.integers(-1, n, e).astype(np.int32)
    targets = rng.normal(size=(n, 8)).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return feats, src, dst, targets, mask


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_forward_and_gradients_match_reference(aggregator, mode):
    """The forward and the masked loss's value and gradients; the unmasked
    loss (the mean over every node) in the unrolled mode."""
    cfg, jcfg = _cfgs(aggregator, mode)
    jp, tp = _jax_params(), _port_params()
    g = _graph(1)
    args = [torch.from_numpy(a) for a in g]
    _close(gnn.forward(cfg, tp, *args[:3]), jgnn.forward(jcfg, jp, *g[:3]))
    for mask in (True, False) if mode == "unrolled" else (True,):
        jl, jg = jax.value_and_grad(
            lambda p: jgnn.loss_fn(jcfg, p, *g[:4], g[4] if mask else None))(jp)
        tl, tg = value_and_grad(
            lambda p: gnn.loss_fn(cfg, p, *args[:4], args[4] if mask else None), tp)
        _close(tl, jl)
        tree_map(_close, tg, jax.tree.map(np.asarray, jg))


def test_abstract_params_match_reference_eval_shape():
    for cfg_t, cfg_j, d_feat in ((get_arch("graphcast").CONFIG, jget_arch("graphcast").CONFIG,
                                  602),
                                 (*_cfgs(), D_FEAT)):
        port = gnn.abstract_params(cfg_t, d_feat)
        ref = jgnn.abstract_params(cfg_j, d_feat)

        def same(t, s):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(s.shape)
            assert str(t.dtype).replace("torch.", "") == str(s.dtype)

        tree_map(same, port, ref)
        assert len(jax.tree.leaves(port)) == len(jax.tree.leaves(ref))
    # the full width's parameter count at d_feat 602 (the minibatch cell)
    n = sum(t.numel() for t in jax.tree.leaves(gnn.abstract_params(
        get_arch("graphcast").CONFIG, 602)))
    assert n == 26_149_091


def test_init_params_shapes_and_scales():
    cfg = dataclasses.replace(get_arch("graphcast").SMOKE_CONFIG, d_hidden=64)
    p = gnn.init_params(cfg, torch.Generator().manual_seed(0), d_feat=D_FEAT)
    ref = jax.tree.map(np.asarray, jgnn.init_params(
        dataclasses.replace(jget_arch("graphcast").SMOKE_CONFIG, d_hidden=64),
        jax.random.PRNGKey(0), d_feat=D_FEAT))
    tree_map(lambda t, r: (t.shape == r.shape) or pytest.fail(f"{t.shape} {r.shape}"), p, ref)
    w = p["edge_mlps"][0]["w"]  # [3, 128, 64]: N(0, 1 / 128)
    assert float(w.std()) == pytest.approx(128 ** -0.5, rel=0.05)
    assert not torch.equal(w[0], w[1])  # each layer its own draw
    assert float(p["node_mlps"][1]["b"].abs().max()) == 0.0


def test_gnn_config_matches_reference():
    from repro.models.configs_base import GNNConfig as JGNNConfig

    assert ([(f.name, f.default) for f in dataclasses.fields(GNNConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JGNNConfig)])
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert (dataclasses.asdict(getattr(get_arch("graphcast"), name))
                == dataclasses.asdict(getattr(jget_arch("graphcast"), name)))
    assert get_arch("graphcast").FAMILY == "gnn"
