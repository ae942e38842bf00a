"""The sharding-spec tables of the port (`repro_torch.dist.sharding`)
against the reference's (`repro.dist.sharding`), leaf by leaf, on the
CPU: every spec builder over every architecture's full-width parameter
(and cache) tree gives the reference's PartitionSpec as a tuple, entry
for entry; `to_placements` maps single and tuple axes onto a mesh.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import gnn, lm, recsys  # noqa: E402

LM_ARCHS = ["mistral-large-123b", "granite-8b", "gemma2-2b", "olmoe-1b-7b", "arctic-480b"]
RECSYS_ARCHS = ["dien", "sasrec", "wide-deep", "din"]


def _path_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _ref_leaves(specs) -> dict:
    """{path: spec as a tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_path_name(k) for k in path): tuple(spec) for path, spec in flat}


def _port_leaves(specs) -> dict:
    out = {}
    _walk(specs, (), out)
    return out


def _walk(tree, path, out):
    """A port spec tree's leaves (tuples of entries) by path; a spec is a
    tuple whose entries are None, str or tuples of str."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, path + (str(k),), out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            _walk(getattr(tree, f), path + (f,), out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _walk(v, path + (str(i),), out)
    else:
        out[path] = tree


def _shapes_equal(port_tree, ref_tree):
    got = {}
    sh.tree_map_with_path(lambda p, x: got.__setitem__(p, tuple(getattr(x, "shape", ()))),
                          port_tree)
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    want = {tuple(_path_name(k) for k in path): tuple(x.shape) for path, x in flat}
    assert got == want


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_equal_reference(arch):
    params = lm.abstract_params(get_arch(arch).CONFIG)
    jparams = jlm.abstract_params(j_get_arch(arch).CONFIG)
    _shapes_equal(params, jparams)
    got, want = _port_leaves(sh.lm_param_specs(params)), _ref_leaves(jsh.lm_param_specs(jparams))
    assert got == want
    assert any("model" in spec for spec in got.values())


@pytest.mark.parametrize("cache_axes", [None, "kv", "dh", "none"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
@pytest.mark.parametrize("batch_axis", ["data", ("pod", "data"), None])
def test_lm_cache_specs_equal_reference(arch, cache_axes, batch_axis):
    cache = lm.abstract_cache(get_arch(arch).CONFIG, 32, 64)
    jcache = jlm.abstract_cache(j_get_arch(arch).CONFIG, 32, 64)
    got = _port_leaves(sh.lm_cache_specs(cache, batch_axis, "model", cache_axes=cache_axes))
    want = _ref_leaves(jsh.lm_cache_specs(jcache, batch_axis, "model", cache_axes=cache_axes))
    assert got == want
    assert got[("length",)] == ()


def test_lm_cache_specs_refuse_a_bad_value():
    cache = lm.abstract_cache(get_arch("gemma2-2b").SMOKE_CONFIG, 2, 8)
    with pytest.raises(ValueError, match="cache_axes must be None, 'kv', 'dh' or 'none'"):
        sh.lm_cache_specs(cache, None, cache_axes="heads")


def test_gnn_param_specs_equal_reference():
    cfg, jcfg = get_arch("graphcast").CONFIG, j_get_arch("graphcast").CONFIG
    for d_feat in (128, 1433):
        params, jparams = gnn.abstract_params(cfg, d_feat), jgnn.abstract_params(jcfg, d_feat)
        _shapes_equal(params, jparams)
        assert (_port_leaves(sh.gnn_param_specs(params))
                == _ref_leaves(jsh.gnn_param_specs(jparams)))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_param_specs_equal_reference(arch):
    params = recsys.abstract_params(get_arch(arch).CONFIG)
    jparams = jrec.abstract_params(j_get_arch(arch).CONFIG)
    _shapes_equal(params, jparams)
    assert (_port_leaves(sh.recsys_param_specs(params))
            == _ref_leaves(jsh.recsys_param_specs(jparams)))


def test_axis_sizes_and_guard_equal_reference():
    assert sh.AXIS_SIZES == jsh.AXIS_SIZES
    for axes in (None, "model", ("pod", "data"), ("data", "model"), ("pod", "data", "model")):
        assert sh.axis_product(axes) == jsh.axis_product(axes)
        for dim in (8, 16, 32, 48, 512, 1000):
            assert sh._guard(dim, axes) == jsh._guard(dim, axes)


def test_to_placements_single_and_tuple_axes():
    from torch.distributed.tensor import Replicate, Shard

    with make_debug_mesh(2, 2) as mesh:
        assert sh.to_placements(("data", None), mesh) == [Shard(0), Replicate()]
        assert sh.to_placements((None, "model"), mesh) == [Replicate(), Shard(1)]
        assert sh.to_placements((("data", "model"),), mesh) == [Shard(0), Shard(0)]
        assert sh.to_placements((None, None), mesh) == [Replicate(), Replicate()]
        assert sh.to_placements((), mesh) == [Replicate(), Replicate()]
        with pytest.raises(ValueError, match=r"names axes \['pod'\]"):
            sh.to_placements((("pod", "data"), None), mesh)
    with make_debug_mesh(2, 2, pod=2) as mesh:  # pod and data: one mesh dim of 4
        assert sh.mesh_axes(mesh) == [("pod", "data"), ("model",)]
        assert sh.to_placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(1)]
        assert sh.to_placements((("pod", "data", "model"),), mesh) == [Shard(0)] * 2
        assert sh.to_placements((None, "model"), mesh) == [Replicate(), Shard(1)]
        with pytest.raises(ValueError, match="no dimension of the mesh"):
            sh.to_placements(("data", None), mesh)
    assert not torch.distributed.is_initialized()
