"""AFMoE (Trinity-Mini) in the port against its plain reference,
`repro_torch.models.afmoe_ref`, on seeded random weights at
`SMOKE_CONFIG` (8 layers: two dense, then MoE layers, full attention on
layers 3 and 7): the forward (plain attention and K9's plain version),
the routing, the FOPO-LM step through `ExecutionPlan.execute` on the
kernels' plain versions, the expert share of each device adding up to
the uncut layer, the fp32 masters under a bf16 trunk, and the counters.

Tolerances: fp32 on both sides, the same products in other orders
(chunked online softmax, grouped products, sums of a token's rows):
1e-5 of the largest magnitude for activations, 1e-4 relative for the
gradients (a few rows carry the reward, so a gradient is a short sum)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs.trinity_mini import CONFIG, SMOKE_CONFIG, layer_types
from repro_torch.core.fopo import FOPOConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.mips.ivf import build_ivf
from repro_torch.models import afmoe_ref as ref
from repro_torch.models import lm, moe
from repro_torch.obs.trace import Tracer, tracing
from repro_torch.optim.optimizers import adam, tree_leaves

CFG = SMOKE_CONFIG


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Tiny ops: under parallel test workers, intra-op threads waiting on
    cores the other workers hold would set the time, not the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg=CFG, seed=0):
    p = lm.init_params(cfg, torch.Generator().manual_seed(seed))
    return p, p.pop("unembed")


def _tokens(cfg=CFG, b=2, s=24, seed=1):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


def _close(a, b, tol=1e-5):
    assert float((a - b).abs().max()) <= tol * float(b.abs().max()), float((a - b).abs().max())


def test_config_is_the_published_one():
    assert CONFIG.layer_types == layer_types(32) and CONFIG.layer_types[:4] == (
        "sliding", "sliding", "sliding", "full")
    assert (CONFIG.d_model, CONFIG.num_heads, CONFIG.num_kv_heads, CONFIG.dh) == (2048, 32, 4, 128)
    assert (CONFIG.num_experts, CONFIG.num_experts_per_tok, CONFIG.moe_d_ff) == (128, 8, 1024)
    assert (CONFIG.num_dense_layers, CONFIG.d_ff, CONFIG.vocab_size) == (2, 6144, 200_192)
    assert CONFIG.route_scale == 2.826 and CONFIG.num_shared_experts == 1
    assert SMOKE_CONFIG.num_layers >= 8 and "full" in SMOKE_CONFIG.layer_types[2:]
    from repro_torch.configs import ARCH_IDS, get_arch

    assert get_arch("trinity-mini").CONFIG == CONFIG and "trinity-mini" not in ARCH_IDS


def test_param_count_is_the_tree():
    cfg = dataclasses.replace(CFG, held_experts=(4, 8))
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(p)) == cfg.param_count()
    assert p["moe_layers"]["we_gate"].shape[1] == 4 and p["moe_layers"]["router"].shape[2] == 16


@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_reference(flash):
    cfg = dataclasses.replace(CFG, use_flash_kernel=flash)
    params, _ = _params(cfg)
    tok = _tokens(cfg)
    rec = {}
    h = lm.final_hidden(cfg, params, tok, rec)
    h_ref, inputs, sels = ref.forward(cfg, params, tok)
    _close(h, h_ref)
    assert len(rec["routes"]) == len(sels) == cfg.num_layers - cfg.num_dense_layers
    for z, z_ref, s, s_ref in zip(rec["moe_inputs"], inputs, rec["routes"], sels):
        _close(z, z_ref)
        assert torch.equal(s.sort(1).values, s_ref.sort(1).values)


def test_windows_and_positions_follow_the_layer_types():
    assert [lm.layer_window(CFG, i) for i in range(4)] == [8, 8, 8, None]
    params, _ = _params()
    tok = _tokens(s=40)
    h = lm.final_hidden(CFG, params, tok)
    sliding = dataclasses.replace(CFG, layer_types=("sliding",) * CFG.num_layers)
    assert float((lm.final_hidden(sliding, params, tok) - h).abs().max()) > 1e-3


@pytest.mark.parametrize("route_norm", [True, False])
def test_routing_is_sigmoid_top_k_normed_and_scaled(route_norm):
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(40, 64, generator=g), torch.randn(64, 16, generator=g) / 8
    sel, wt = moe.afmoe_route(x, w, k=4, route_norm=route_norm, route_scale=2.826)
    s = torch.sigmoid(x @ w)
    top = torch.topk(s, 4, dim=-1)
    assert torch.equal(sel.sort(1).values, top.indices.sort(1).values)
    want = top.values / (top.values.sum(-1, keepdim=True) + 1e-20) if route_norm else top.values
    _close(wt, want * 2.826, 1e-6)
    sel_r, w_r, _ = ref.route(x, w, 4, route_norm, 2.826)
    assert torch.equal(sel, sel_r)
    _close(wt, w_r, 1e-6)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four devices each hold 4 of the 16 experts: their outputs added,
    with the shared expert (which every device computes) counted once,
    are the uncut reference layer's."""
    params, _ = _params()
    lay = {k: v[1] for k, v in params["moe_layers"].items()}
    z = torch.randn(48, CFG.d_model, generator=torch.Generator().manual_seed(5))
    kw = dict(k=CFG.num_experts_per_tok, route_norm=True, route_scale=CFG.route_scale)
    parts = []
    for r in range(4):
        held = {**lay, **{k: lay[k][4 * r:4 * r + 4] for k in ("we_gate", "we_up", "we_down")}}
        parts.append(moe.afmoe_moe(z, held, held=(4 * r, 4 * r + 4), **kw))
    shared = ref.swiglu(z, lay["ws_gate"][0], lay["ws_up"][0], lay["ws_down"][0])
    uncut, _ = ref.moe_layer(CFG, z, lay, (0, 16))
    _close(sum(parts) - 3 * shared, uncut)
    whole = moe.afmoe_moe(z, lay, held=(0, 16), **kw)
    _close(whole, uncut)


def _plan(cfg, beta):
    index = build_ivf(beta, 16, kmeans_iters=4, seed=3, device="cpu")
    fc = FOPOConfig(num_items=cfg.vocab_size, num_samples=64, top_k=32, epsilon=0.5,
                    retriever="ivf_pallas", fused=True, fused_sampler=True)
    return ExecutionPlan.resolve(fc, retriever_kwargs={"index": index, "n_probe": 4})


def _batch(cfg, seed=1):
    tok = _tokens(cfg, s=32, seed=seed)
    labels = torch.cat([tok[:, 1:], torch.full_like(tok[:, :1], -1)], dim=1)
    return {"tokens": tok, "labels": labels}


def _recording_plan(plan, seen):
    """``plan`` with the draws each step takes kept in ``seen``."""
    draw = plan.draw

    def recording(*a, **kw):
        out = draw(*a, **kw)
        seen.append(out)
        return out

    object.__setattr__(plan, "draw", recording)
    return plan


def test_fopo_step_loss_and_gradients_match_reference():
    cfg = dataclasses.replace(CFG, held_experts=(4, 8))
    params, beta = _params(cfg)
    batch = _batch(cfg)
    seen = []
    plan = _recording_plan(_plan(cfg, beta), seen)
    opt = adam(1e-3, in_place=True)
    state = opt.init(params)
    before = {k: {n: t.clone() for n, t in g.items()} if isinstance(g, dict) else g.clone()
              for k, g in params.items()}
    step = lm.make_train_step(cfg, opt, "fopo", plan=plan, unembed=beta)
    _, state, loss, aux = step(params, state, batch, 7)
    (sample,) = seen
    valid = sample.actions >= 0
    rewards = ((sample.actions.clamp(min=0) == batch["labels"].reshape(-1, 1)) & valid).float()
    assert float(rewards.sum()) > 0
    loss_r, ess_r, _, grads_r = ref.loss_and_grads(cfg, before, batch["tokens"], beta,
                                                   sample.actions, sample.log_q, rewards)
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    assert float(aux["ess"]) == pytest.approx(float(ess_r), rel=1e-5)
    # Adam's first moment after one step from zero is (1 - b1) g
    for m, g_r in zip(tree_leaves(state["m"]), tree_leaves(grads_r)):
        g = m / 0.1
        assert float((g - g_r).norm()) <= 1e-4 * float(g_r.norm()) + 1e-12


def test_bf16_trunk_keeps_fp32_masters():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    params, beta = _params(cfg)
    opt = adam(1e-3, in_place=True)
    state = opt.init(params)
    step = lm.make_train_step(cfg, opt, "fopo", plan=_plan(cfg, beta), unembed=beta)
    ptrs = [t.data_ptr() for t in tree_leaves(params)]
    for i in range(2):
        rec = {}
        params, state, loss, _ = step(params, state, _batch(cfg, i), i, record=rec)
        assert torch.isfinite(loss)
        assert all(z.dtype == torch.bfloat16 for z in rec["moe_inputs"])
    assert [t.data_ptr() for t in tree_leaves(params)] == ptrs  # updated in place
    for tree in (params, state["m"], state["v"]):
        assert all(t.dtype == torch.float32 for t in tree_leaves(tree))
    assert lm.compute_params(cfg, params)["moe_layers"]["router"].dtype == torch.float32


def test_counters_count_each_pass():
    """The proposal pass, the checkpointed forward and its recomputation
    count forward; the backward once."""
    cfg = CFG
    params, beta = _params(cfg)
    opt = adam(1e-3, in_place=True)
    step = lm.make_train_step(cfg, opt, "fopo", plan=_plan(cfg, beta), unembed=beta)
    tracer = Tracer()
    with tracing(tracer):
        step(params, opt.init(params), _batch(cfg), 0)
    tot = tracer.counter_totals()
    b, s = 2, 32
    n_moe = cfg.num_layers - cfg.num_dense_layers
    fwd, bwd = tot["moe.rows"][:3], tot["moe.rows"][3:]
    assert fwd[0] == 3 * bwd[0] == 3 * n_moe * b * s
    assert fwd[1] == 3 * bwd[1] == 3 * n_moe * b * s * cfg.num_experts_per_tok  # all held
    from repro_torch.kernels.flash_attention.kernel import live_pairs

    n_full = cfg.layer_types.count("full")
    assert tot["attention.pairs.full_backward"] == n_full * b * live_pairs(s, s, True, None, 0)
    n_sl = cfg.num_layers - n_full
    assert tot["attention.pairs.sliding_backward"] == n_sl * b * live_pairs(s, s, True, 8, 0)
    assert tot["attention.pairs.sliding"] == 3 * tot["attention.pairs.sliding_backward"]
