"""The port's GNN message passing at its edge cases, against the
reference's on the CPU (the weights, graphs and tolerances of
`test_torch_gnn.py`): a node that only padded edges reach, a node no
edge reaches, and tied maxima under the ``max`` aggregator.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map, value_and_grad  # noqa: E402
from test_torch_gnn import _cfgs, _close, _graph, _jax_params, _port_params  # noqa: E402


@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_node_reached_only_by_padded_edges(aggregator):
    """Node 0 gets only the clamped padded edges (src or dst -1), node 1
    no edge at all: both aggregate to 0 under every aggregator (``max``:
    -inf mapped to 0), as in the reference, with the same gradients."""
    cfg, jcfg = _cfgs(aggregator, "unrolled")
    feats, _, _, targets, mask = _graph(2)
    src = np.asarray([2, 3, 4, -1, 5, -1, 0, -1], np.int32)
    dst = np.asarray([3, 4, 2, 0, -1, -1, 5, 6], np.int32)
    jp, tp = _jax_params(), _port_params()
    h = torch.from_numpy(feats)
    args = [torch.from_numpy(a) for a in (feats, src, dst, targets, mask)]
    out = gnn.forward(cfg, tp, *args[:3])
    _close(out, jgnn.forward(jcfg, jp, feats, src, dst))
    # with node 0 and 1 isolated, their rows equal a graph without the padded edges
    keep = (src >= 0) & (dst >= 0)
    bare = gnn.forward(cfg, tp, h, torch.from_numpy(src[keep]), torch.from_numpy(dst[keep]))
    torch.testing.assert_close(out, bare, rtol=1e-6, atol=1e-6)
    assert torch.isfinite(out).all()
    jl, jg = jax.value_and_grad(lambda p: jgnn.loss_fn(jcfg, p, feats, src, dst, targets, mask))(jp)
    tl, tg = value_and_grad(lambda p: gnn.loss_fn(cfg, p, *args), tp)
    _close(tl, jl)
    tree_map(_close, tg, jax.tree.map(np.asarray, jg))
    assert all(torch.isfinite(t).all() for t in tree_leaves(tg))


def test_max_ties_split_the_gradient_evenly():
    """Tied maxima share the gradient evenly in `scatter_reduce` amax, as
    in `jax.ops.segment_max`: the same split on the same inputs, and
    through the model's ``max`` aggregator two duplicated edges (equal
    messages) get equal gradients."""
    src = np.asarray([1.0, 1.0, 0.0, 5.0], np.float32)
    seg = np.asarray([0, 0, 0, 1])
    w = np.asarray([3.0, 5.0], np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(jax.ops.segment_max(x, seg, 2) * w))(src)
    t = torch.from_numpy(src).requires_grad_(True)
    out = torch.full((2,), float("-inf")).scatter_reduce(
        0, torch.from_numpy(seg), t, "amax", include_self=False)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(t.grad.numpy(), [1.5, 1.5, 0.0, 5.0])
    # the model: edge 2 -> 3 twice and 4 -> 3 once; the duplicates tie everywhere
    cfg, jcfg = _cfgs("max", "unrolled")
    feats, _, _, targets, mask = _graph(3)
    s = np.asarray([2, 2, 4, 5], np.int32)
    d = np.asarray([3, 3, 3, 6], np.int32)
    jp, tp = _jax_params(), _port_params()
    jl, jg = jax.value_and_grad(lambda p: jgnn.loss_fn(jcfg, p, feats, s, d, targets, mask))(jp)
    tl, tg = value_and_grad(lambda p: gnn.loss_fn(
        cfg, p, *(torch.from_numpy(a) for a in (feats, s, d, targets, mask))), tp)
    _close(tl, jl)
    tree_map(_close, tg, jax.tree.map(np.asarray, jg))
