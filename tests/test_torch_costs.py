"""The port's shape cells and model-FLOP costs against the reference's,
on the CPU: `configs.all_cells` yields the reference's 40 cells in its
order, every arch has the reference's SHAPES / SKIPPED_SHAPES, each
MODEL_FLOPS estimator of `repro_torch.launch.costs` gives the reference's
number for every cell (the same float arithmetic, so exactly), and
`roofline_terms` is the reference's arithmetic under the card's
constants (NVIDIA H100 SXM datasheet figures).
"""
import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import all_cells as j_all_cells  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.launch import costs as jcosts  # noqa: E402
from repro_torch.configs import ARCH_IDS, all_cells, get_arch  # noqa: E402
from repro_torch.launch import costs  # noqa: E402
from repro_torch.obs.drift import HBM_BYTES_PER_S  # noqa: E402

PKG = Path(costs.__file__).resolve().parents[1]


def _as_tuple(cells):
    return [(a, s, dataclasses.asdict(c), r) for a, s, c, r in cells]


def test_all_cells_equal_reference():
    got, want = list(all_cells()), list(j_all_cells())
    assert len(got) == len(want) == 40
    assert _as_tuple(got) == _as_tuple(want)
    assert _as_tuple(all_cells(include_skipped=True)) == _as_tuple(j_all_cells(True))
    assert [r for *_, r in got if r] == [r for *_, r in want if r]  # 4 skipped long_500k


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_every_arch_has_the_reference_shapes(arch):
    assert ARCH_IDS == J_ARCH_IDS
    mod, jmod = get_arch(arch), j_get_arch(arch)
    assert mod.FAMILY == jmod.FAMILY
    assert {k: dataclasses.asdict(v) for k, v in mod.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jmod.SHAPES.items()}
    assert mod.SKIPPED_SHAPES == jmod.SKIPPED_SHAPES


def _estimators(family):
    return {"lm": (costs.lm_model_flops, jcosts.lm_model_flops),
            "gnn": (costs.gnn_model_flops, jcosts.gnn_model_flops),
            "recsys": (costs.recsys_model_flops, jcosts.recsys_model_flops)}[family]


@pytest.mark.parametrize("cell_index", range(40))
def test_model_flops_equal_reference_on_every_cell(cell_index):
    arch, shape, cell, _ = list(all_cells())[cell_index]
    _, jshape, jcell, _ = list(j_all_cells())[cell_index]
    assert shape == jshape
    mod, jmod = get_arch(arch), j_get_arch(arch)
    port_fn, ref_fn = _estimators(mod.FAMILY)
    want = ref_fn(jmod.CONFIG, jcell)
    got = port_fn(mod.CONFIG, cell)
    assert isinstance(got, float) and got > 0
    assert got == want, (arch, shape, got, want)
    # also on the reference's own config and cell objects
    assert port_fn(jmod.CONFIG, jcell) == want


def test_mlp_flops_and_bad_kinds_as_reference():
    for dims in ((4, 8, 1), (72, 200, 80, 1), (1280 + 13, 1024, 512, 256, 1)):
        assert costs._mlp_flops(dims) == jcosts._mlp_flops(dims)
    cell = dataclasses.replace(get_arch("sasrec").SHAPES["train_batch"], kind="graph")
    for fn in (costs.recsys_model_flops, jcosts.recsys_model_flops):
        with pytest.raises(ValueError):
            fn(get_arch("sasrec").CONFIG, cell)
    lm_cell = dataclasses.replace(get_arch("gemma2-2b").SHAPES["train_4k"], kind="serve")
    with pytest.raises(ValueError):
        costs.lm_model_flops(get_arch("gemma2-2b").CONFIG, lm_cell)


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (1e15, 1e12, 1e9, 1), (1e12, 5e12, 0.0, 4), (1e9, 1e6, 1e12, 4), (0.0, 0.0, 0.0, 1)])
def test_roofline_terms_is_the_reference_arithmetic_on_the_card(monkeypatch, flops, nbytes,
                                                               coll, chips):
    monkeypatch.setattr(jcosts, "PEAK_FLOPS", costs.PEAK_FLOPS)
    monkeypatch.setattr(jcosts, "HBM_BW", costs.HBM_BW)
    monkeypatch.setattr(jcosts, "ICI_BW", costs.LINK_BW)
    got = costs.roofline_terms(flops, nbytes, coll, chips)
    assert got == jcosts.roofline_terms(flops, nbytes, coll, chips)
    assert got["compute_s"] == flops / (chips * 989e12)
    assert got["memory_s"] == nbytes / (chips * 3.35e12)
    assert got["collective_s"] == coll / (chips * 450e9)


def test_constants_are_the_cards_and_defined_once():
    assert (costs.PEAK_FLOPS, costs.HBM_BW, costs.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert costs.HBM_BW is HBM_BYTES_PER_S
    tpu = re.compile(r"\b(197e12|819e9|50e9)\b")
    offenders = [str(f) for f in PKG.rglob("*.py") if tpu.search(f.read_text())]
    assert not offenders, offenders
