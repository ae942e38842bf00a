"""The port's cell programs (`repro_torch.launch.specs`) against the
reference's (`repro.launch.specs`), on the CPU: for every cell that is not
skipped, on the pod and the multi-pod mesh, and for the optimised
variants, the abstract arguments have the reference's shapes and
dtypes, the specs are the reference's PartitionSpecs entry for entry,
every sharded dim divides its axes, and the model FLOPs, loop trips and
donated arguments are the reference's. Also the reference's
`tests/test_programs.py` cases: 40 cells with 4 skipped, the skip
reasons, the GQA decode cache that never shards Dh and the divisible-KV
cache that stays sharded.

Two leaves differ by design (`launch/specs.py`): the recsys train step's
seed is an int where the reference's key is a [2] uint32 (its spec ()
against P(None)), and the KV cache's `length` is an int where the
reference's is a 0-dim int32 (spec () in both).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.dist.sharding import AXIS_SIZES  # noqa: E402
from repro_torch.launch.specs import build_program  # noqa: E402

CELLS = [(a, s) for a, s, _, reason in all_cells() if reason is None]
SKIPPED = [(a, s, r) for a, s, _, r in all_cells() if r is not None]
OPT_CELLS = [(a, s) for a, s in CELLS
             if get_arch(a).FAMILY == "lm" or (a == "sasrec" and s == "train_batch")]


@functools.cache
def _ref_program(arch, shape, multi_pod, opt):
    return jspecs.build_program(arch, shape, multi_pod=multi_pod, opt=opt)


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _at(tree, path):
    """The port tree's node at a reference path (dict keys, NamedTuple
    fields, sequence indices)."""
    for k in path:
        k = _key(k)
        tree = getattr(tree, k) if isinstance(k, str) and hasattr(tree, "_fields") else tree[k]
    return tree


def _ref_specs(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]


def _is_seed(prog, path) -> bool:
    return get_arch(prog.arch_id).FAMILY == "recsys" and len(path) == 1 and _key(path[0]) == 3


def _check_program(arch, shape, multi_pod, opt):
    prog = build_program(arch, shape, multi_pod=multi_pod, opt=opt)
    ref = _ref_program(arch, shape, multi_pod, opt)
    # arguments: shapes and dtypes, leaf for leaf
    flat = jax.tree_util.tree_flatten_with_path(tuple(ref.args))[0]
    n_args = 0
    for path, want in flat:
        got = _at(tuple(prog.args), path)
        if _is_seed(prog, path) or (_key(path[-1]) == "length" and not want.shape):
            assert isinstance(got, int), (path, got)
            continue
        n_args += 1
        assert tuple(got.shape) == tuple(want.shape), (path, got.shape, want.shape)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (path, got.dtype)
    assert n_args == len(flat) - sum(
        1 for p, w in flat if _is_seed(prog, p) or (_key(p[-1]) == "length" and not w.shape))
    # specs, entry for entry, and every sharded dim divides its axes
    for path, want in _ref_specs(tuple(ref.in_specs)):
        got = _at(tuple(prog.in_specs), path)
        if _is_seed(prog, path):
            assert got == () and tuple(want) == (None,)
            continue
        assert got == tuple(want), (path, got, want)
        leaf = _at(tuple(prog.args), path)
        for dim, axes in zip(getattr(leaf, "shape", ()), got):
            if axes is None:
                continue
            size = 1
            for a in (axes,) if isinstance(axes, str) else axes:
                size *= AXIS_SIZES[a]
            assert dim % size == 0, (arch, shape, path, leaf.shape, got)
    if ref.out_specs is not None:
        for path, want in _ref_specs(ref.out_specs):
            assert _at(prog.out_specs, path) == tuple(want), path
    assert prog.model_flops == ref.model_flops > 0
    assert tuple(prog.loop_trips) == tuple(ref.loop_trips)
    assert prog.donate_argnums == ref.donate_argnums
    assert prog.note == ref.note


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_program_equals_reference(arch, shape, multi_pod):
    _check_program(arch, shape, multi_pod, False)


@pytest.mark.parametrize("arch,shape", OPT_CELLS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_opt_program_equals_reference(arch, shape, multi_pod):
    _check_program(arch, shape, multi_pod, True)


def test_pool_has_40_cells():
    assert len(CELLS) + len(SKIPPED) == 40
    assert len(SKIPPED) == 4  # long_500k on the 4 pure full-attention archs


def test_skip_reasons_documented():
    for arch, shape, reason in SKIPPED:
        assert "full-attention" in reason
        assert shape in get_arch(arch).SKIPPED_SHAPES


def _decode_cache_specs(arch):
    prog = build_program(arch, "decode_32k")
    cache, spec = prog.args[2], prog.in_specs[2]
    return [getattr(spec, f) for f in ("k", "v") if len(getattr(cache, f).shape) == 5]


def test_gqa_decode_cache_never_shards_head_dim():
    specs = _decode_cache_specs("gemma2-2b")
    assert specs
    for spec in specs:
        assert spec[3] is None and spec[4] is None, spec


def test_divisible_kv_decode_cache_stays_sharded():
    specs = _decode_cache_specs("olmoe-1b-7b")
    assert specs
    for spec in specs:
        assert spec[3] == "model" and spec[4] is None, spec
