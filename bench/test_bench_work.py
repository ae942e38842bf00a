"""The yardstick's arithmetic at small shapes: the FLOP counts against
torch's own count of the reference's products, the byte counts against
the tensors they describe, the bound, the percentile, and the reduction
of a trace to busy time and named idle gaps."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.reference import fopo as fopo_ref
from bench.reference import sasrec as sasrec_ref
from bench.yardstick import gen, peaks, work
from bench.yardstick.stats import percentile
from bench.yardstick.trace import SPAN_PREFIX, summarize


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("b,p,l,s", [(4, 50, 8, 6), (3, 17, 5, 9)])
def test_fopo_step_flops_match_the_reference_products(b, p, l, s):
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(b, l, generator=g), torch.randn(l, l, generator=g)
    beta = torch.randn(p, l, generator=g)
    a = torch.randint(0, p, (b, s), generator=g)
    coeff = torch.randn(b, s, generator=g)

    def step():
        h = x @ w
        _ = h @ beta.T
        _ = torch.einsum("bl,bsl->bs", h, beta[a])
        g_h = torch.einsum("bs,bsl->bl", coeff, beta[a])
        _ = x.T @ g_h

    assert _flops(step) == work.fopo_step_flops(b, p, l, s)


@pytest.mark.parametrize("b,p,l,s,c", [(4, 60, 8, 6, 5), (3, 40, 5, 9, 4)])
def test_fopo_ivf_step_flops_match_the_reference_products(b, p, l, s, c):
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(b, l, generator=g), torch.randn(l, l, generator=g)
    beta = torch.randn(p, l, generator=g)
    cents, lists = sasrec_ref.build_index(beta, c, 7, "fp32", iters=2)
    a = torch.randint(0, p, (b, s), generator=g)
    coeff = torch.randn(b, s, generator=g)
    probe = torch.topk((x @ w) @ cents.T, 2, dim=1).indices
    probed = float((lists[probe] >= 0).sum())

    def step():
        h = x @ w
        _ = h @ cents.T
        for r in range(b):  # each query's probed live candidates
            cand = lists[probe[r]].flatten()
            _ = beta[cand[cand >= 0].long()] @ h[r:r + 1].T
        _ = torch.einsum("bl,bsl->bs", h, beta[a])
        g_h = torch.einsum("bs,bsl->bl", coeff, beta[a])
        _ = x.T @ g_h

    assert _flops(step) == work.fopo_ivf_step_flops(b, l, s, c, probed)


def test_mips_topk_counts():
    flops, nbytes = work.mips_topk(4096, 750_000, 100, 256)
    assert flops == 2 * 4096 * 750_000 * 100
    assert nbytes == 4 * (750_000 * 100 + 4096 * 100 + 2 * 4096 * 256)
    t, which = peaks.bound_s(nbytes, flops)
    assert which == "flops" and t == pytest.approx(flops / 495e12)


@pytest.mark.parametrize("b,t,d,blocks", [(3, 5, 8, 2), (2, 7, 4, 1)])
def test_sasrec_tower_flops_match_the_reference_tower(b, t, d, blocks):
    g = torch.Generator().manual_seed(2)
    params = gen.sasrec_params(50, d, t, blocks, g)
    hist = torch.randint(-1, 50, (b, t), generator=g)
    got = _flops(lambda: sasrec_ref.user_vectors(params, hist, 1, "fp32"))
    assert got == work.sasrec_tower_flops(b, t, d, blocks)


def test_ivf_probe_counts_each_probed_list_once():
    lists = torch.tensor([[0, 1, -1], [2, -1, -1], [3, 4, 5]])
    probe = torch.tensor([[0, 2], [0, 1]])  # list 0 probed twice
    live = (lists >= 0).sum(dim=1)
    union = float(live[torch.unique(probe)].sum())
    probed = float(live[probe].sum())
    assert (union, probed) == (6.0, 8.0)
    flops, nbytes = work.ivf_probe(2, 4, 3, 2, union, probed)
    assert flops == 2 * 4 * 8
    assert nbytes == 6 * 4 * (4 + 1) + 2 * 4 * (4 + 2 + 2 * 3)
    assert work.centroid_stage_flops(2, 3, 4) == 2 * 2 * 3 * 4


def test_bound_takes_the_larger_term():
    assert peaks.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert peaks.bound_s(1.0, 2 * 495e12) == (2.0, "flops")


def test_percentile_nearest_rank():
    vs = list(range(1, 101))
    assert percentile(vs, 95) == 95 and percentile(vs, 50) == 51 and percentile([3.0], 95) == 3.0


def test_trace_busy_gaps_and_spans():
    ms = 1_000_000
    events = [
        (SPAN_PREFIX + "window", False, 0, 100 * ms),
        (SPAN_PREFIX + "train", False, 0, 100 * ms),
        (SPAN_PREFIX + "dispatch", False, 10 * ms, 30 * ms),
        (SPAN_PREFIX + "dispatch", False, 60 * ms, 70 * ms),
        ("void (anonymous namespace)::mips_probe_kernel<true>(float const*)", True, 5 * ms,
         15 * ms),
        ("fused_sampler_kernel(int)", True, 12 * ms, 40 * ms),  # overlaps the first
        ("Memcpy HtoD", True, 95 * ms, 120 * ms),  # clipped at the window's end
        (SPAN_PREFIX + "train", True, 0, 100 * ms),  # a range's device copy: not work
    ]
    s = summarize(events)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.040)
    assert s.ops["mips_probe_kernel<true>"] == pytest.approx(0.010)
    assert s.op_counts == {"mips_probe_kernel<true>": 1, "fused_sampler_kernel": 1,
                           "Memcpy HtoD": 1}
    assert s.spans["dispatch"] == pytest.approx([0.020, 0.010])
    # idle 0-5 (train), 40-95: its midpoint 67.5 lies in the second dispatch
    assert s.idle == pytest.approx({"train": 0.005, "dispatch": 0.055})
    assert s.top_idle(1) == [["dispatch", pytest.approx(0.055)]]


def test_reference_sampler_is_the_configured_counter_hash_stream():
    """The reference's frozen sampler draws what the program's plain
    version of the in-kernel sampler draws, bit for bit."""
    from repro_torch.kernels.fused_sampler.ref import fused_sampler_ref

    g = torch.Generator().manual_seed(3)
    scores, ids = torch.topk(torch.randn(5, 300, generator=g), 16, dim=1)
    ids = ids.to(torch.int32)
    shape = fopo_ref.FopoShape(num_items=300, embed_dim=4, num_samples=21, top_k=16,
                               epsilon=0.8, learning_rate=1e-4, sample_tile=8, batch=5)
    a, lq = fopo_ref.mixture_draws(12345, ids, scores, shape, block=2)
    a2, lq2, _ = fused_sampler_ref(12345, torch.tensor(0.8), ids, scores, num_samples=21,
                                   num_items=300, sample_tile=8)
    assert torch.equal(a, a2) and torch.equal(lq, lq2)
