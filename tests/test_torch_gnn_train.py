"""The port's GNN in training: `repro_torch.models.gnn.make_train_step`
with the port's Adam against the reference's, on the CPU, at graphcast's
SMOKE_CONFIG (the weights and graphs of `test_torch_gnn.py`), and the
reference's own GNN tests (`tests/test_models.py`) mirrored.

Tolerances, as `test_torch_moe_train.py` holds its steps: loss rtol
1e-5, parameters within 1e-6 + 1e-5 |p| on all but 0.1 % of each leaf's
entries and within 2e-2 lr everywhere, but for entries whose first
moment is under 1e-4 of the leaf's largest, held within 2 lr (Adam's g /
(|g| + eps) turns an fp32 difference in a gradient entry near 0 into an
update difference of up to ~lr); moments at rtol 1e-4 / atol 1e-5 times
the leaf's largest. Each step is held from the reference's state before
it.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import adam_state_from_numpy, gnn_params_from_numpy  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from test_torch_gnn import _cfgs, _graph, _jax_params, _port_params  # noqa: E402

LR = 1e-3


@functools.cache
def _jax_steps(aggregator: str, mode: str, steps: int):
    """[(the state a step starts from as numpy (params, Adam state), what
    it gives)] for ``steps`` reference Adam steps, each on its own graph."""
    _, jcfg = _cfgs(aggregator, mode)
    opt = joptim.adam(LR)
    params = _jax_params()
    state = opt.init(params)
    step = jax.jit(jgnn.make_train_step(jcfg, opt))
    out = []
    for i in range(steps):
        start = jax.tree.map(np.asarray, (params, state))
        params, state, loss = step(params, state, *_graph(10 + i))
        out.append((start, _record(loss, params, state)))
    return out


def _record(loss, params, state) -> dict:
    np_ = (lambda t: t.detach().numpy()) if isinstance(loss, torch.Tensor) else np.asarray
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        else:
            flat[prefix] = np_(tree)

    for name, tree in (("p", params), ("m", state["m"]), ("v", state["v"])):
        walk(tree, name)
    return dict(loss=float(loss), flat=flat)


def _port_step(aggregator, mode, i, start):
    cfg, _ = _cfgs(aggregator, mode)
    opt = optim.adam(LR)
    params, state = gnn_params_from_numpy(start[0]), adam_state_from_numpy(start[1])
    params, state, loss = gnn.make_train_step(cfg, opt)(
        params, state, *(torch.from_numpy(a) for a in _graph(10 + i)))
    return _record(loss, params, state)


def _assert_step_close(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert sorted(got["flat"]) == sorted(want["flat"])
    for name, b in want["flat"].items():
        if not name.startswith("p/"):
            continue
        diff = np.abs(got["flat"][name] - b)
        assert (diff > 1e-6 + 1e-5 * np.abs(b)).mean() <= 1e-3, name
        m = np.abs(want["flat"]["m" + name[1:]])
        near0 = m < 1e-4 * m.max()
        assert diff[~near0].max(initial=0.0) <= 2e-2 * LR, name
        assert diff[near0].max(initial=0.0) <= 2 * LR, name
        for mom in ("m", "v"):
            w = want["flat"][mom + name[1:]]
            np.testing.assert_allclose(got["flat"][mom + name[1:]], w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(), err_msg=f"{mom} {name}")


@pytest.mark.parametrize("aggregator,mode", [("sum", "scan_remat"), ("mean", "scan"),
                                             ("max", "unrolled")])
def test_adam_trajectory_matches_reference(aggregator, mode):
    """10 Adam steps, each on its own graph: the port's free trajectory
    from the reference's initial weights keeps the reference's losses
    (rtol 1e-4: Adam carries step 1's near-0 entries into later
    gradients), and each step taken from the reference's state before it
    gives the reference's parameters and moments."""
    ref = _jax_steps(aggregator, mode, 10)
    cfg, _ = _cfgs(aggregator, mode)
    opt = optim.adam(LR)
    params = _port_params()
    state = opt.init(params)
    step = gnn.make_train_step(cfg, opt)
    losses = []
    for i in range(10):
        params, state, loss = step(params, state, *(torch.from_numpy(a) for a in _graph(10 + i)))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, [w["loss"] for _, w in ref], rtol=1e-4)
    assert losses[-1] < losses[0]
    for i, (start, want) in enumerate(ref):
        _assert_step_close(_port_step(aggregator, mode, i, start), want)


# -- the reference's own GNN tests, mirrored (tests/test_models.py) -------------

def test_gnn_smoke():
    cfg = get_arch("graphcast").SMOKE_CONFIG
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), d_feat=12)
    n, e = 64, 256
    g = torch.Generator().manual_seed(1)
    feats = torch.randn((n, 12), generator=g)
    src = torch.randint(-1, n, (e,), generator=g, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
    out = gnn.forward(cfg, params, feats, src, dst)
    assert out.shape == (n, cfg.n_vars)
    assert torch.isfinite(out).all()
    opt = optim.adam(1e-3)
    step = gnn.make_train_step(cfg, opt)
    tgt = torch.randn((n, cfg.n_vars), generator=g)
    mask = torch.ones((n,))
    p, st, loss0 = step(params, opt.init(params), feats, src, dst, tgt, mask)
    for _ in range(15):
        p, st, loss = step(p, st, feats, src, dst, tgt, mask)
    assert float(loss) < float(loss0)


def test_gnn_padding_edges_are_inert():
    """Edges marked -1 must not affect the output."""
    cfg = get_arch("graphcast").SMOKE_CONFIG
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), d_feat=6)
    n = 20
    feats = torch.randn((n, 6), generator=torch.Generator().manual_seed(1))
    src = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    out1 = gnn.forward(cfg, params, feats, src, dst)
    src_p = torch.cat([src, torch.full((7,), -1, dtype=torch.int32)])
    dst_p = torch.cat([dst, torch.full((7,), -1, dtype=torch.int32)])
    out2 = gnn.forward(cfg, params, feats, src_p, dst_p)
    torch.testing.assert_close(out1, out2, rtol=1e-5, atol=1e-6)




def test_train_cli_matches_reference_cli(monkeypatch, capsys):
    """`python -m repro_torch.launch.train --arch graphcast --device cpu`
    against the reference's CLI on the reference's initial weights (the
    port's `init_params` patched to carry them across): the same graph,
    inputs and Adam steps, so the printed losses agree within 1e-4."""
    import re
    import sys

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    def ref_weights(cfg, generator, d_feat=None, device=None):  # noqa: ARG001
        jcfg = _cfgs()[1]
        return gnn_params_from_numpy(jax.tree.map(
            np.asarray, jgnn.init_params(jcfg, jax.random.PRNGKey(0), d_feat=d_feat)))

    monkeypatch.setattr(gnn, "init_params", ref_weights)
    ttrain.main(["--arch", "graphcast", "--steps", "3", "--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "graphcast", "--steps", "3"])
    jtrain.main()
    want = capsys.readouterr().out
    pat = re.compile(r"^step (\d+): loss=([-0-9.]+)$", re.M)
    g, w = pat.findall(got), pat.findall(want)
    assert [i for i, _ in g] == [i for i, _ in w] == ["0", "1", "2"]
    np.testing.assert_allclose([float(x) for _, x in g], [float(x) for _, x in w], rtol=1e-4)


# -- the static padded inputs of a shape cell --------------------------------------

def _gnn_cells():
    mod = get_arch("graphcast")
    return sorted({**mod.SHAPES, **mod.SKIPPED_SHAPES})


@pytest.mark.parametrize("name", _gnn_cells())
def test_static_shape_matches_reference_program(name):
    """`static_shape` gives the node and edge counts the reference's
    dry-run program declares for the cell."""
    from repro.configs import get_arch as jget_arch
    from repro.launch import specs

    jmod = jget_arch("graphcast")
    jcell = {**jmod.SHAPES, **jmod.SKIPPED_SHAPES}[name]
    prog = specs._gnn_program("graphcast", jmod, jcell, multi_pod=False)
    feats, src = prog.args[2], prog.args[3]
    mod = get_arch("graphcast")
    cell = {**mod.SHAPES, **mod.SKIPPED_SHAPES}[name]
    assert gnn.static_shape(cell) == (feats.shape[0], src.shape[0])


def test_subgraph_inputs_gather_the_sampled_rows():
    """A sampled subgraph at its cell's static shape: its nodes' rows in
    order, zero rows and -1 edges past them, the mask on the seeds; and
    the step's loss on it equals the loss on the subgraph unpadded."""
    import dataclasses

    from repro_torch.data import random_graph, sample_neighbors

    cell = dataclasses.replace(get_arch("graphcast").SHAPES["minibatch_lg"], n_nodes=300,
                               d_feat=7, batch_nodes=8, fanout=(4, 3))
    n, e = gnn.static_shape(cell)
    assert (n, e) == (512, 512)
    rng = np.random.default_rng(0)
    sub = sample_neighbors(random_graph(cell.n_nodes, avg_degree=6, seed=0),
                           rng.choice(cell.n_nodes, cell.batch_nodes, replace=False),
                           cell.fanout, rng)
    cfg = get_arch("graphcast").SMOKE_CONFIG
    table = torch.from_numpy(rng.standard_normal((cell.n_nodes, cell.d_feat)).astype(np.float32))
    table_y = torch.from_numpy(rng.standard_normal((cell.n_nodes, cfg.n_vars)).astype(np.float32))
    x, src, dst, y, mask = gnn.subgraph_inputs(sub, table, table_y, n, e)
    m, k = len(sub.node_ids), len(sub.edge_src)
    assert x.shape == (n, cell.d_feat) and y.shape == (n, cfg.n_vars) and src.shape == (e,)
    torch.testing.assert_close(x[:m], table[sub.node_ids], rtol=0, atol=0)
    torch.testing.assert_close(y[:m], table_y[sub.node_ids], rtol=0, atol=0)
    assert not x[m:].any() and not y[m:].any()
    np.testing.assert_array_equal(src[:k].numpy(), sub.edge_src)
    np.testing.assert_array_equal(dst[:k].numpy(), sub.edge_dst)
    assert (src[k:] == -1).all() and (dst[k:] == -1).all()
    assert mask.tolist() == [1.0] * sub.num_seeds + [0.0] * (n - sub.num_seeds)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), d_feat=cell.d_feat)
    bare = gnn.loss_fn(cfg, params, table[sub.node_ids], torch.from_numpy(sub.edge_src),
                       torch.from_numpy(sub.edge_dst), table_y[sub.node_ids], mask[:m])
    torch.testing.assert_close(gnn.loss_fn(cfg, params, x, src, dst, y, mask), bare,
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="does not fit"):
        gnn.subgraph_inputs(sub, table, table_y, m - 1, e)
