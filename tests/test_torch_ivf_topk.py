"""The port's `ivf_topk` (`repro_torch.kernels.ivf_topk`) against the JAX
reference's, on the CPU.

The port's wrapper runs its plain PyTorch version here (CPU tensors);
the reference runs its Pallas kernel in interpret mode. Both query the
SAME index: the reference builds it and `repro_torch.convert` carries it
across, because the two packages seed k-means from different RNGs.
Tolerances are `test_torch_common.assert_topk_equal`'s. The kernel itself is
held to the plain version on the card by `chip_smoke.py`; its launch
geometry (ranges of the lists, tiles of live rows, lanes per row, the
rows' ticket counters) is checked here without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_common import assert_topk_equal, data, jax_index, to_port  # noqa: E402

from repro.kernels.ivf_topk import ivf_topk as jax_ivf_topk  # noqa: E402
from repro_torch.kernels.ivf_topk import ivf_topk, kernel, ops, tile_align_index  # noqa: E402
from repro_torch.kernels import _launch  # noqa: E402


@pytest.mark.parametrize(
    "p,l,c,b,k,n_probe,cap_tile",
    [
        (500, 16, 8, 4, 16, 3, 8),     # ragged clusters, CT | cap
        (777, 8, 16, 5, 32, 8, 16),    # odd P
        (256, 32, 4, 3, 8, 2, 128),    # CT > cap -> clamped to cap
        (300, 16, 8, 4, 16, 5, 7),     # CT does not divide cap -> pad path
        (64, 8, 64, 2, 8, 64, 8),      # one item per cluster (C == P region)
    ],
)
def test_ivf_topk_matches_reference(p, l, c, b, k, n_probe, cap_tile):
    _, jindex = jax_index(p, l, c, seed=p + k, key=3, kmeans_iters=6)
    _, q = data(p, l, b, seed=p + k)
    ref = jax_ivf_topk(
        jnp.asarray(q), jindex, k, n_probe=n_probe, cap_tile=cap_tile,
        interpret=True,
    )
    index, _ = tile_align_index(to_port(jindex), cap_tile)
    out = ivf_topk(torch.from_numpy(q), index, k, n_probe=n_probe)
    assert_topk_equal(out, ref)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and never the kernel."""
    _, jindex = jax_index(100, 8, 8, seed=1, key=2)
    _, q = data(100, 8, 3, seed=1)
    kernel_before = ops._kernel.ivf_probe_topk_cuda.launches
    plain_before = ops._ref.ivf_probe_topk_ref.calls
    ivf_topk(torch.from_numpy(q), to_port(jindex), 4, n_probe=2)
    assert ops._kernel.ivf_probe_topk_cuda.launches == kernel_before
    assert ops._ref.ivf_probe_topk_ref.calls == plain_before + 1


def test_tracer_counts_the_rows_probed_from_the_probe_ids():
    """With a tracer active, `ivf_topk` counts from the probe ids it hands
    stage 2: the queries, each query's probed lists' live rows, the
    union's, the delta pass's apart, and answers as without one."""
    from repro_torch.obs.trace import Tracer, tracing

    _, jindex = jax_index(500, 16, 8, seed=516, key=3, kmeans_iters=6)
    _, q = data(500, 16, 6, seed=9)
    index, qt = to_port(jindex), torch.from_numpy(q)
    c, cap = index.lists.shape
    delta_lists = torch.full((c, 4), -1, dtype=torch.int32)
    delta_lists[1, :2] = torch.tensor([3, 7])
    delta_lists[5, 0] = 11
    delta = (delta_lists, torch.zeros(c, 4, index.list_embs.shape[-1]))
    bare = ivf_topk(qt, index, 8, n_probe=3, delta=delta)
    tracer = Tracer()
    with tracing(tracer):
        out = ivf_topk(qt, index, 8, n_probe=3, delta=delta)
    assert torch.equal(out.scores, bare.scores) and torch.equal(out.indices, bare.indices)
    probe = torch.topk(qt @ index.centroids.T, 3, dim=1).indices

    def rows(lists):
        live = (lists >= 0).sum(dim=1)
        return int(live[probe].sum()), int(live[torch.unique(probe)].sum())

    (probed, union), (d_probed, d_union) = rows(index.lists), rows(delta_lists)
    assert tracer.counter_totals() == {"ivf_topk.queries": 6,
                                       "ivf_topk.rows": [probed, union, d_probed, d_union]}
    assert ops.ROW_FIELDS == ("probed_rows", "union_rows", "delta_probed_rows",
                              "delta_union_rows")
    assert probed > union > 0
    with tracing(tracer):  # without delta lists: the main pass's fields alone
        ivf_topk(qt, index, 8, n_probe=3)
    assert tracer.counter_totals()["ivf_topk.rows"] == [2 * probed, 2 * union, d_probed, d_union]
    # a list's live rows are counted again once its table changes in place
    c0 = int(probe[0, 0])
    dead = int((index.lists[c0] >= 0).sum())
    index.lists[c0] = -1
    tracer = Tracer()
    with tracing(tracer):
        ivf_topk(qt, index, 8, n_probe=3)
    probed2, union2 = rows(index.lists)
    assert tracer.counter_totals()["ivf_topk.rows"] == [probed2, union2, 0, 0]
    assert union2 == union - dead and probed2 < probed


@pytest.mark.parametrize(
    "batch,n_probe,capp,k,l",
    [
        (8, 8, 2048, 10, 50),    # SASRec serving
        (8, 8, 2048, 256, 50),   # SASRec at K 256
        (8, 8, 2048, 10, 18),    # DIEN's width
        (8, 8, 4096, 4, 2304),   # the Gemma-2 route
        (8, 8, 512, 4, 2304),    # full lists at the LM width
        (8, 8, 8, 10, 50),       # the delta lists
        (1, 1, 300, 10, 7),      # one row, one probe
        (4096, 8, 2048, 10, 50),  # a large batch
        (2, 64, 8, 8, 8),        # every cluster probed
    ],
)
def test_splits_cover_each_list_in_ranges_of_at_most_1024(batch, n_probe, capp, k, l):
    """Each probed list is cut into ranges of a multiple of 32 slots, at
    most 1024 (four ids a thread), that cover it exactly once; a small
    batch gets enough blocks to fill the card, and the merge's partial
    lists fit its shared memory."""
    splits, chunk = kernel.splits_for(batch, n_probe, capp, k, l)
    assert chunk % 32 == 0 and 32 <= chunk <= kernel.MAX_CHUNK
    assert (splits - 1) * chunk < capp <= splits * chunk
    # ranges no longer than those that fill two blocks per SM of 132
    # (rounded up to 32 slots), unless the merge would need a second staging
    want = min(-(-264 // (batch * n_probe)), max(1, 10240 // (n_probe * k)))
    assert chunk < -(-capp // want) + 32 or chunk == kernel.MAX_CHUNK
    assert n_probe * splits <= 10240


def test_splits_at_the_serving_shapes():
    """SASRec (B 8, n_probe 8, capp 2048, L 50): 6 ranges of 352 slots,
    whose live rows fit the two 204-row tiles a block copies at once; at
    K 256 the merge's 8 * splits * 256 pairs stay within one staging (5);
    the LM width streams 4-row tiles, its ranges set by the fill alone."""
    assert kernel.splits_for(8, 8, 2048, 10, 50) == (6, 352)
    assert kernel.splits_for(8, 8, 2048, 256, 50) == (5, 416)
    assert kernel.splits_for(8, 8, 4096, 4, 2304) == (5, 832)
    assert kernel.splits_for(8, 8, 8, 10, 50) == (1, 32)


@pytest.mark.parametrize("l", [1, 7, 18, 50, 100, 2302, 2304, 10240])
def test_tile_rows_and_lanes_per_row(l):
    """A tile is whole rows within 40 KB, at most 256; a row is scored by
    a power-of-two group of lanes, up to a warp, about one lane per 16 of
    its words."""
    t, g = kernel.tile_rows(l), kernel.lanes_per_row(l)
    assert 1 <= t <= 256 and t * l * 4 <= 40 * 1024
    assert t == 256 or (t + 1) * l * 4 > 40 * 1024
    assert g in (1, 2, 4, 8, 16, 32)
    words = l // 4 if l % 4 == 0 else l
    assert g == 32 or g * 16 >= words
    assert g == 1 or (g // 2) * 16 < words


def test_tile_rows_refuse_a_row_wider_than_a_tile():
    with pytest.raises(ValueError, match="L=10241"):
        kernel.tile_rows(10241)


def test_ticket_counters_are_zero_and_kept_per_stream_and_capture(monkeypatch):
    """One zeroed int32 [B] buffer per (device, stream, B), reused by the
    next launch (each launch leaves it at 0); another stream, batch or
    CUDA-graph capture gets its own. K7 takes them from `_launch`, which
    keeps them for every kernel whose last block of a row finishes it."""
    monkeypatch.setattr(_launch, "_COUNTERS", {})
    dev = torch.device("cpu")
    a = _launch.ticket_counters(dev, 11, 8)
    assert a.dtype == torch.int32 and a.shape == (8,) and not a.any()
    assert _launch.ticket_counters(dev, 11, 8) is a
    others = [_launch.ticket_counters(dev, 12, 8), _launch.ticket_counters(dev, 11, 4),
              _launch.ticket_counters(dev, 11, 8, capture=5)]
    assert all(o is not a for o in others) and len({id(o) for o in others}) == 3
    assert _launch.ticket_counters(dev, 11, 8, capture=5) is others[2]
    assert _launch.ticket_counters(dev, 11, 8) is a  # eager launches never take a capture's
