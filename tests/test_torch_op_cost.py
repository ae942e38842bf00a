"""The op cost walker (`repro_torch.launch.jaxpr_cost`) against the
reference's jaxpr walker (`repro.launch.jaxpr_cost.analyze`), on the CPU,
on small programs and on SMOKE_CONFIG forward and train steps of the LM,
GNN and recsys families.

What must agree exactly: the products' FLOPs (2 M N K batch each; the
reference's dot_general rule walked through its scans). What agrees
within a tolerance, and why: the total FLOPs within 5 % (elementwise
ops are 1 FLOP an element in both, but torch and jaxpr decompose
softmax, rms_norm and the optimizer into different primitives), the
bytes within 30 % (the reference also counts 2 x each scan carry per
trip, and materialises other intermediates than aten's softmax or
log-softmax). Gemma-2's products differ by design: the reference
computes both attention windows of every layer and selects one, the
port only the layer's own.

Also: the trace extrapolated along the loops equals the unrolled one at
a small size (`launch.dryrun`), K9's and K10's cost rule is the bound
arithmetic at `PERF.md`'s prefill and training shapes, and a fake or
meta tensor through `flash_attention` reaches the fake implementations,
never ctypes or a plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.launch import jaxpr_cost as jc  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.optim.optimizers import adam as jadam  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import jaxpr_cost as pc  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import gnn, lm, recsys  # noqa: E402
from repro_torch.optim.optimizers import adam  # noqa: E402
from test_torch_common import small_cell  # noqa: E402

FLOPS_RTOL = 0.05
BYTES_RTOL = 0.30


def S(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def M(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ref_product_flops(jaxpr) -> float:
    """The reference walker's dot_general FLOPs, through its scans."""
    total = 0.0
    for e in jaxpr.eqns:
        p = e.primitive.name
        if p == "dot_general":
            total += jc._dot_general_cost(e).flops
        elif p == "scan":
            total += e.params["length"] * _ref_product_flops(e.params["jaxpr"].jaxpr)
        elif p == "cond":
            total += max(_ref_product_flops(b.jaxpr) for b in e.params["branches"])
        elif p == "while":
            total += _ref_product_flops(e.params["body_jaxpr"].jaxpr)
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if key in e.params:
                    inner = e.params[key]
                    total += _ref_product_flops(getattr(inner, "jaxpr", inner))
                    break
    return total


def _compare(jfn, jargs, pfn, pargs, same_program=True):
    want = jc.analyze(jfn, *jargs)
    want_products = _ref_product_flops(jax.make_jaxpr(jfn)(*jargs).jaxpr)
    got = pc.analyze(pfn, *pargs)
    if same_program:
        assert got["product_flops"] == want_products
        assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_RTOL)
        assert got["bytes"] == pytest.approx(want["bytes"], rel=BYTES_RTOL)
    return got, want, want_products


def test_small_programs():
    def mlp(w1, w2, x):
        return (jnp.tanh(x @ w1) @ w2).sum()

    got, want, _ = _compare(mlp, (S((32, 48)), S((48, 16)), S((8, 32))),
                            lambda w1, w2, x: (torch.tanh(x @ w1) @ w2).sum(),
                            (M((32, 48)), M((48, 16)), M((8, 32))))
    assert got["product_flops"] == 2 * 8 * 32 * 48 + 2 * 8 * 48 * 16
    # a batched product and a reduction
    got, want, _ = _compare(lambda a, b: jnp.einsum("bij,bjk->bik", a, b).max(axis=-1),
                            (S((4, 8, 16)), S((4, 16, 5))),
                            lambda a, b: torch.einsum("bij,bjk->bik", a, b).amax(dim=-1),
                            (M((4, 8, 16)), M((4, 16, 5))))
    assert got["product_flops"] == 2 * 4 * 8 * 5 * 16
    assert got["flops"] == want["flops"] and got["bytes"] == want["bytes"]


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b", "arctic-480b", "gemma2-2b"])
def test_lm_forward(arch):
    jcfg, cfg = j_get_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
    got, _, want_products = _compare(
        lambda p, t: jlm.forward(jcfg, p, t)[0], (jlm.abstract_params(jcfg), S((2, 16), jnp.int32)),
        lambda p, t: lm.forward(cfg, p, t)[0], (lm.abstract_params(cfg), M((2, 16), torch.int32)),
        same_program=not cfg.local_global_alternating,
    )
    if cfg.local_global_alternating:
        # the reference computes both windows of every layer: the port's
        # products are the reference's less one window's attention a layer
        b, s, h, dh = 2, 16, cfg.num_heads, cfg.dh
        assert want_products - got["product_flops"] == cfg.num_layers * 2 * (2 * b * h * s * s * dh)


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_lm_train_step(arch):
    jcfg, cfg = j_get_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
    jo, po = jadam(1e-3), adam(1e-3)
    jp, pp = jlm.abstract_params(jcfg), lm.abstract_params(cfg)
    _compare(jlm.make_train_step(jcfg, jo),
             (jp, jax.eval_shape(jo.init, jp), S((2, 16), jnp.int32), S((2, 16), jnp.int32)),
             lm.make_train_step(cfg, po),
             (pp, po.init(pp), M((2, 16), torch.int32), M((2, 16), torch.int32)))


def test_gnn_train_step():
    jcfg, cfg = j_get_arch("graphcast").SMOKE_CONFIG, get_arch("graphcast").SMOKE_CONFIG
    jo, po = jadam(1e-3), adam(1e-3)
    jp, pp = jgnn.abstract_params(jcfg, 8), gnn.abstract_params(cfg, 8)
    n, e, nv = 64, 128, cfg.n_vars
    _compare(jgnn.make_train_step(jcfg, jo),
             (jp, jax.eval_shape(jo.init, jp), S((n, 8)), S((e,), jnp.int32),
              S((e,), jnp.int32), S((n, nv)), S((n,))),
             gnn.make_train_step(cfg, po),
             (pp, po.init(pp), M((n, 8)), M((e,), torch.int32), M((e,), torch.int32),
              M((n, nv)), M((n,))))


@pytest.mark.parametrize("arch", ["din", "dien", "wide-deep", "sasrec"])
def test_recsys_forward_and_train_step(arch):
    jcfg, cfg = j_get_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
    jp, pp = jrec.abstract_params(jcfg), recsys.abstract_params(cfg)
    if cfg.kind == "wide_deep":
        jb = {"sparse": S((4, cfg.n_sparse), jnp.int32), "dense": S((4, cfg.n_dense)),
              "label": S((4,))}
        pb = {"sparse": M((4, cfg.n_sparse), torch.int32), "dense": M((4, cfg.n_dense)),
              "label": M((4,))}
    else:
        jb = {"hist": S((4, cfg.seq_len), jnp.int32), "target": S((4,), jnp.int32),
              "label": S((4,))}
        pb = {"hist": M((4, cfg.seq_len), torch.int32), "target": M((4,), torch.int32),
              "label": M((4,))}
    _compare(lambda p, b: jrec.forward(jcfg, p, b), (jp, jb),
             lambda p, b: recsys.forward(cfg, p, b), (pp, pb))
    if arch != "sasrec":  # the BCE step (SASRec trains by FOPO, whose draws differ)
        jo, po = jadam(1e-3), adam(1e-3)
        _compare(jrec.make_train_step(jcfg, jo), (jp, jax.eval_shape(jo.init, jp), jb,
                                                  S((2,), jnp.uint32)),
                 recsys.make_train_step(cfg, po), (pp, po.init(pp), pb, 0))


# ---------------------------------------------------------------------------
# the trace extrapolated along the loops equals the unrolled one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,cfg_kw", [
    ("gemma2-2b", "prefill_32k", dict(num_layers=8)),
    ("granite-8b", "prefill_32k", dict(num_layers=4)),
    ("olmoe-1b-7b", "decode_32k", dict(num_layers=4)),
    ("graphcast", "molecule", dict(num_layers=4)),
])
def test_extrapolated_trace_equals_unrolled(monkeypatch, arch, shape, cfg_kw):
    small_cell(monkeypatch, arch, shape, **cfg_kw)
    assert dryrun.trace_points(arch, shape)["layers"][0] == cfg_kw["num_layers"]
    with make_debug_mesh(2, 2) as mesh:
        scaled = dryrun.run_cell(arch, shape, multi_pod=False, mesh=mesh)
        unrolled = dryrun.run_cell(arch, shape, multi_pod=False, mesh=mesh, unrolled=True)
    assert scaled["traced_at"] and unrolled["traced_at"] is None
    for key in ("hlo_flops", "hlo_bytes_accessed", "collective_bytes", "collective_counts"):
        assert scaled[key] == unrolled[key], key
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert scaled["memory"][key] == unrolled["memory"][key], key
    # the peak: each phase's extrapolated apart; equal while the same
    # moment of each phase holds its peak at every size
    assert scaled["memory"]["peak_bytes"] == pytest.approx(unrolled["memory"]["peak_bytes"],
                                                           rel=0.02)
    assert sum(scaled["collective_by_depth"].values()) == unrolled["collective_bytes"]["total"]


# ---------------------------------------------------------------------------
# K9 / K10: the cost rule, the fake implementations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,dtype", [(8, 2048, torch.bfloat16), (1, 2048, torch.float32),
                                       (4, 2048, torch.float32)])
def test_flash_cost_rule_is_the_bound_arithmetic(b, s, dtype):
    """Gemma-2's prefill (B 8, bf16) and training (B 1 and 4, fp32)
    shapes: H 8, KV 4, D 256, causal, soft-cap 50."""
    h, kv, d = 8, 4, 256
    q = torch.empty((b, s, h, d), dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty((b, s, kv, d), dtype=dtype, device="meta", requires_grad=True)
    r = pc.analyze(lambda q_, k_: fops.flash_attention(q_, k_, k_, logit_cap=50.0), q, k)
    live = s * (s + 1) // 2  # causal
    item = torch.tensor([], dtype=dtype).element_size()
    flops, products, nbytes = fk.attention_work(b, s, s, h, kv, d, item, True, None, 0)
    assert (flops, products) == (b * h * live * 2 * d, 2)
    assert nbytes == (2 * b * s * h * d + 2 * b * s * kv * d) * item + b * h * s * 4
    assert r["kernel_ops"] == {"flash_attention_fwd": 1}
    assert r["flops"] == 2 * flops
    # forward and backward: 2 + 5 products
    r = pc.analyze(lambda q_, k_: torch.autograd.grad(
        fops.flash_attention(q_, k_, k_, logit_cap=50.0).sum(), (q_, k_)), q, k)
    fb, pb, nb = fk.attention_work(b, s, s, h, kv, d, item, True, None, 0, backward=True)
    assert (fb, pb) == (flops, 5)
    assert nb == (3 * b * s * h * d + 4 * b * s * kv * d) * item + 2 * b * h * s * 4
    assert r["kernel_ops"] == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    assert r["product_flops"] == 0  # no aten product: the kernels' work is in their rule
    assert r["flops"] >= 7 * flops


def _refuse(*_, **__):
    raise AssertionError("a fake tensor reached ctypes or a plain version")


def test_fake_cuda_tensors_reach_the_fake_implementations(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    for name in ("flash_attention_fwd_cuda", "flash_attention_bwd_cuda", "library",
                 "bwd_library"):
        monkeypatch.setattr(fops._kernel, name, _refuse)
    for name in ("flash_attention_ref", "flash_attention_bwd_ref"):
        monkeypatch.setattr(fops._ref, name, _refuse)
    with FakeTensorMode():
        q = torch.empty((2, 64, 8, 32), device="cuda")
        k = torch.empty((2, 64, 4, 32), device="cuda")
        assert q.is_cuda
        out, lse = fops.flash_attention_fwd(q, k, k, window=16, logit_cap=30.0)
        assert out.shape == q.shape and out.is_cuda and lse.shape == (2, 8, 64)
        assert lse.dtype == torch.float32
        dsum = torch.empty((2, 8, 64), device="cuda")
        dq, dk, dv = fops._bwd_op(q, k, k, torch.ones_like(out), lse, dsum, True, None, None, 0)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape and dk.is_cuda
    # autograd's forward and backward on meta tensors (a fake CUDA leaf
    # needs a build of torch with CUDA)
    q = torch.empty((2, 64, 8, 32), device="meta", requires_grad=True)
    k = torch.empty((2, 64, 4, 32), device="meta", requires_grad=True)
    dq, dk = torch.autograd.grad(fops.flash_attention(q, k, k).sum(), (q, k))
    assert dq.shape == q.shape and dk.shape == k.shape


def test_a_kernel_op_with_no_cost_rule_raises(monkeypatch):
    monkeypatch.delitem(pc.KERNEL_RULES, "flash_attention_fwd")
    q = torch.empty((1, 16, 2, 16), device="meta")
    with pytest.raises(NotImplementedError, match="flash_attention_fwd has no cost rule"):
        pc.analyze(lambda q_: fops.flash_attention(q_, q_, q_), q)
