"""`bench/yardstick/lm_work.py` at a tiny size: its FLOP counts against
torch's own count of the reference's products and against the masks'
live pairs, the useful step's assembly, and the three readers of the
FOPO-LM cell on a traced tiny run's context (silent without device time
or counters)."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import harness
from bench.reference import afmoe as ref
from bench.tinycells import tiny_cell, tiny_run
from bench.yardstick import lm_gen, lm_work
from bench.yardstick.peaks import TF32_FLOPS
from bench.yardstick.trace import TraceSummary

CELL = "trinity-mini.fopo-lm-s8k"
METRICS = ("train_step_mfu.lm", "moe_experts_roofline", "flash_attention_roofline.lm")


def _tiny(seq_len=24, sequences=2):
    c = tiny_cell(CELL).config
    sh = lm_work.LMShape.of(c, sequences, seq_len, 8)
    return c, sh


@pytest.mark.parametrize("s,window", [(24, 8), (24, None), (40, 16), (10, 16)])
def test_live_pairs_are_the_masks(s, window):
    from repro_torch.kernels.flash_attention.kernel import live_pairs

    i = torch.arange(s)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask = mask & (i[:, None] - i[None, :] < window)
    assert lm_work.live_pairs(s, window) == int(mask.sum()) == live_pairs(s, s, True, window, 0)


def test_one_pass_flops_match_the_reference_products(monkeypatch):
    """A forward pass of the reference with every window wider than the
    sequence and one query block, so that its attention multiplies every
    (query, key) pair: torch's count of its products is the dense
    projections, the router, the experts' rows and 4 Dh H S^2 a sequence
    and layer."""
    c, sh = _tiny()
    c = {**c, "sliding_window": 10**6}
    monkeypatch.setattr(ref, "Q_BLOCK", 10**6)
    m = ref.Model.of({**c, "layer_types": ["full" if t == "full_attention" else "sliding"
                                           for t in c["layer_types"]]})
    params = lm_gen.afmoe_params(c, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, c["vocab_size"], (sh.sequences, sh.seq_len),
                           generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as fc:
        _, _, sels = ref.forward(m, params, tokens)
    lo, hi = c["held_experts"]
    held = sum(int(((s >= lo) & (s < hi)).sum()) for s in sels)
    n_moe = sh.layers - sh.dense_layers
    rows = [sh.tokens * n_moe, held, 0]
    bf16, f32 = lm_work._dense_forward(sh)
    attn = sh.layers * sh.sequences * sh.heads * 4 * sh.dh * sh.seq_len**2
    assert fc.get_total_flops() == bf16 + f32 + lm_work.expert_work(sh, rows, False)[0] + attn


def test_attention_and_expert_work_scale_with_the_counts():
    _, sh = _tiny()
    pairs = sh.sequences * lm_work.live_pairs(sh.seq_len, sh.window)
    f, b = lm_work.attention_work(sh, pairs, False)
    assert f == pairs * sh.heads * 4 * sh.dh
    assert lm_work.attention_work(sh, pairs, True)[0] == 2.5 * f
    rows = [sh.tokens, 100, 9]
    ef, eb = lm_work.expert_work(sh, rows, False)
    assert ef == 6 * sh.d * sh.f * (100 + sh.shared * sh.tokens)
    assert lm_work.expert_work(sh, rows, True)[0] == 2 * ef and b > 0 and eb > 0


def test_step_least_time_is_three_passes_and_the_head():
    _, sh = _tiny()
    n_moe = sh.layers - sh.dense_layers
    held = 40 * n_moe
    pairs = {"sliding": 1000, "full": 300}
    program = {"moe.rows": [3 * sh.tokens * n_moe, 3 * held, 30, sh.tokens * n_moe, held, 10],
               "attention.pairs.sliding_backward": pairs["sliding"],
               "attention.pairs.full_backward": pairs["full"], "ivf_topk.rows": [5000, 900, 0, 0]}
    bf16, f32 = lm_work._dense_forward(sh)
    bf16 += sum(pairs.values()) * sh.heads * 4 * sh.dh
    bf16 += 6 * sh.d * sh.f * (held + sh.shared * sh.tokens * n_moe)
    head = (2 * sh.tokens * sh.num_clusters * sh.d + 4 * sh.tokens * sh.num_samples * sh.d
            + 2 * sh.d * 5000)
    want = 3 * bf16 / lm_work.BF16_FLOPS + (3 * f32 + head) / TF32_FLOPS
    assert lm_work.step_least_time(sh, program, 1) == pytest.approx(want, rel=1e-12)
    assert lm_work.step_least_time(sh, {}, 1) is None


def _traced_ctx(monkeypatch):
    seen = {}
    read = harness.read_metric

    def spy(name, ctx):
        seen["ctx"] = ctx
        return read(name, ctx)

    monkeypatch.setattr(harness, "read_metric", spy)
    result, _ = tiny_run(CELL, seed=2**31 + 29, trace=True)
    return result, seen["ctx"]


def test_readers_read_the_programs_counters(monkeypatch):
    result, ctx = _traced_ctx(monkeypatch)
    assert result["correct"]
    prog, sh = ctx["program"], ctx["counters"]["lm"]
    assert prog["moe.rows"][0] == 3 * prog["moe.rows"][3] > 0
    for name in METRICS[1:]:  # no device time on the CPU
        assert harness.read_metric(name, ctx) is None
    ops = {"flash_fwd_kernel<bf16, 128>": 0.2, "flash_bwd_dq_kernel": 0.1,
           "flash_bwd_dkv_kernel": 0.1, lm_work.GROUPED_MM_KERNELS[0] + "_kernel": 0.3}
    trace = TraceSummary(window_s=1.0, busy_s=sum(ops.values()), ops=ops,
                         op_counts=dict.fromkeys(ops, 1), spans={}, idle={})
    ctx = dict(ctx, trace=trace)
    rows = prog["moe.rows"]
    want = (lm_work.bf16_bound_s(*lm_work.expert_work(sh, rows[:3], False))
            + lm_work.bf16_bound_s(*lm_work.expert_work(sh, rows[3:], True)))
    assert harness.read_metric("moe_experts_roofline", ctx) == pytest.approx(100 * want / 0.3)
    fwd = sum(prog[f"attention.pairs.{k}"] for k in ("sliding", "full"))
    bwd = sum(prog[f"attention.pairs.{k}_backward"] for k in ("sliding", "full"))
    want = (lm_work.bf16_bound_s(*lm_work.attention_work(sh, fwd, False))
            + lm_work.bf16_bound_s(*lm_work.attention_work(sh, bwd, True)))
    assert harness.read_metric("flash_attention_roofline.lm", ctx) == pytest.approx(
        100 * want / 0.4)
    mfu = harness.read_metric("train_step_mfu.lm", ctx)
    steps = ctx["counters"]["steps"]
    assert mfu == pytest.approx(100 * lm_work.step_least_time(sh, prog, steps) / 1.0)
    for name in METRICS:
        assert harness.read_metric(name, dict(ctx, program={})) is None
