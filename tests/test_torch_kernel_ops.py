"""K1-K8 as registered operators (`repro_torch/kernels/_library.py`), on
the CPU, one case per operator at a small shape:

* `torch.library.opcheck` passes (schema, fake implementation, the
  autograd registration, AOT dispatch);
* a meta call gives the CPU call's shapes, dtypes and strides, and a
  fake CUDA tensor reaches the fake implementation, never ctypes or a
  plain version;
* the operator's outputs equal its plain version's bit for bit;
* the walker's rule (`launch.jaxpr_cost.KERNEL_RULES`) is the kernel's
  work function (`kernel.py`) at the shape-only upper end, and the work
  function with this input's counts is the arithmetic `chip_smoke.py`
  computed its bounds with before it moved there;
* a DTensor input raises rather than running the plain version: no mesh
  reaches K1-K8 (`dist/fopo.py` runs plain tensors a process, and the
  dry run's recsys cells call none of them);
* an input that requires grad gives outputs that do not (the wrappers
  pass detached tensors, as the kernels' outputs are constants).
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.constants import LOG_Q_PAD  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as ek  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eo  # noqa: E402
from repro_torch.kernels.fused_sampler import kernel as fk  # noqa: E402
from repro_torch.kernels.fused_sampler import ops as fo  # noqa: E402
from repro_torch.kernels.ivf_topk import kernel as ik  # noqa: E402
from repro_torch.kernels.ivf_topk import ops as io  # noqa: E402
from repro_torch.kernels.mips_topk import kernel as mk  # noqa: E402
from repro_torch.kernels.mips_topk import ops as mo  # noqa: E402
from repro_torch.kernels.snis_covgrad import kernel as sk  # noqa: E402
from repro_torch.kernels.snis_covgrad import ops as so  # noqa: E402
from repro_torch.launch import jaxpr_cost as pc  # noqa: E402

B, L, P, S, K = 4, 8, 50, 16, 6  # S a multiple of the sample tile 8: Sp = S


def _rng():
    return np.random.default_rng(0)


def _f(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _i(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


def _covgrad_inputs():
    rng = _rng()
    a = rng.integers(0, P, (B, S))
    a[0, ::3] = -1
    a[-1] = -1  # a row with every slot masked
    lq = np.where(a >= 0, rng.standard_normal((B, S)) - 5, LOG_Q_PAD)
    r = (rng.random((B, S)) < 0.3) * (a >= 0)
    return (_f(rng.standard_normal((B, L))), _f(0.3 * rng.standard_normal((P, L))), _i(a),
            _f(lq), _f(r))


def _bwd_inputs():
    _, beta, a, _, _ = _covgrad_inputs()
    return _f(np.random.default_rng(1).standard_normal((B, S))), a, beta


def _ivf_inputs():
    rng = _rng()
    c, capp = 3, 7
    lists = rng.integers(0, P, (c, capp))
    lists[:, 5:] = -1  # padded slots
    lists[2] = -1  # a dead list
    probe = np.stack([rng.permutation(c)[:2] for _ in range(B)])
    return (_f(rng.standard_normal((B, L))), _i(probe), _i(lists),
            _f(rng.standard_normal((c, capp, L))), K)


def _eb_inputs():
    rng = _rng()
    idx = rng.integers(-1, P + 3, (B, 5))  # padding and ids >= V beside live ones
    idx[1] = -1
    return _f(rng.standard_normal((P, L))), _i(idx)


def _sampler_inputs():
    rng = _rng()
    ids = np.stack([rng.permutation(P)[:K] for _ in range(B)])
    return (7, torch.tensor(0.5), _i(ids), _f(2 * rng.standard_normal((B, K))), S, P, 8, 0)


# name -> (operator, CPU inputs, the plain version's outputs, the plain
# version's function name on the module's ``_ref``)
CASES = {
    "snis_covgrad_fwd": (so._fwd_op, lambda: (*_covgrad_inputs(), True),
                         lambda a: list(so._ref.snis_fwd_ref(*a[:5], covgrad=True)),
                         so, "snis_fwd_ref"),
    "snis_covgrad_fwd_scores": (so._fwd_op, lambda: (*_covgrad_inputs(), False),
                                lambda a: [so._ref.snis_fwd_ref(*a[:5], covgrad=False)],
                                so, "snis_fwd_ref"),
    "snis_covgrad_bwd": (so._bwd_op, _bwd_inputs, lambda a: so._ref.snis_bwd_ref(*a),
                         so, "snis_bwd_ref"),
    "fused_sampler": (fo._op, _sampler_inputs,
                      lambda a: fo._ref.fused_sampler_ref(
                          *a[:4], num_samples=a[4], num_items=a[5], sample_tile=a[6],
                          row_offset=a[7]), fo, "fused_sampler_ref"),
    "mips_topk": (mo._op, lambda: (_covgrad_inputs()[0], _covgrad_inputs()[1], K),
                  lambda a: mo._ref.mips_topk_ref(*a), mo, "mips_topk_ref"),
    "ivf_probe_topk": (io._op, _ivf_inputs, lambda a: io._ref.ivf_probe_topk_ref(*a),
                       io, "ivf_probe_topk_ref"),
    "embedding_bag": (eo._op, _eb_inputs, lambda a: eo._ref.embedding_bag_ref(*a),
                      eo, "embedding_bag_ref"),
}
NAMES = sorted(CASES)


def _outs(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _meta(args):
    return tuple(torch.empty_like(a, device="meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name):
    op, inputs, *_ = CASES[name]
    torch.library.opcheck(op, inputs())


@pytest.mark.parametrize("name", NAMES)
def test_meta_call_gives_the_cpu_call_layout(name):
    op, inputs, *_ = CASES[name]
    args = inputs()
    got, want = _outs(op(*_meta(args))), _outs(op(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_meta
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype, w.stride())


@pytest.mark.parametrize("name", NAMES)
def test_outputs_are_the_plain_version_bit_for_bit(name):
    op, inputs, plain, *_ = CASES[name]
    args = inputs()
    got, want = _outs(op(*args)), _outs(plain(args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _refuse(*_, **__):
    raise AssertionError("a fake tensor reached ctypes or a plain version")


@pytest.mark.parametrize("name", NAMES)
def test_fake_cuda_tensors_reach_the_fake_implementation(monkeypatch, name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, inputs, _, mod, plain = CASES[name]
    for attr in dir(mod._kernel):
        if attr.endswith("_cuda") or attr.endswith("library"):
            monkeypatch.setattr(mod._kernel, attr, _refuse)
    monkeypatch.setattr(mod._ref, plain, _refuse)
    args = inputs()
    with FakeTensorMode():
        fake = tuple(torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
                     if isinstance(a, torch.Tensor) else a for a in args)
        assert fake[2 if name == "fused_sampler" else 0].is_cuda
        outs = _outs(op(*fake))
    assert all(o.is_cuda for o in outs)


# ---------------------------------------------------------------------------
# the cost rules and the work functions
# ---------------------------------------------------------------------------

def _upper_end(name, args):
    """(FLOPs, bytes) of the work function at the shape-only upper end,
    from the arguments' shapes."""
    if name.startswith("snis_covgrad_fwd"):
        f, n, b = sk.snis_fwd_work(B, S, L, P, args[5])
        assert (f, n) == (2 * B * S * L, 3 if args[5] else 1)
        assert b == min(B * S, P) * L * 4 + (B * S * 16 + B * L * 8 if args[5]
                                            else B * S * 8 + B * L * 4)
    elif name == "snis_covgrad_bwd":
        f, n, b = sk.snis_bwd_work(B, S, L, P)
        assert b == min(B * S, P) * L * 4 + B * S * 8 + B * L * 4
    elif name == "fused_sampler":
        f, n, b = fk.sampler_work(B, S, S, K)
        assert (f, b) == (B * S * K, B * K * 8 + B * S * 12)
    elif name == "mips_topk":
        f, n, b = mk.mips_topk_work(B, P, L, K)
    elif name == "ivf_probe_topk":
        c, capp = args[2].shape
        f, n, b = ik.ivf_probe_work(B, L, 2, capp, K)
        assert f == 2 * L * B * 2 * capp  # every slot live
    else:
        f, n, b = ek.embedding_bag_work(*args[1].shape, P, L, 4)
        assert b == min(B * 5, P) * L * 4 + B * 5 * 4 + B * L * 4  # every id distinct
    return f * n, b


@pytest.mark.parametrize("name", NAMES)
def test_rule_is_the_work_function_at_the_upper_end(name):
    op, inputs, *_ = CASES[name]
    args = _meta(inputs())
    key = op._overloadpacket.__name__
    flops, nbytes = _upper_end(name, args)
    assert pc.KERNEL_RULES[key](args, None) == (flops, nbytes)
    r = pc.analyze(lambda *a: op(*a), *args)
    assert r["kernel_ops"] == {key: 1}
    assert r["flops"] == flops and r["product_flops"] == 0
    io_bytes = sum(pc.nbytes(a) for a in args if isinstance(a, torch.Tensor))
    io_bytes += sum(pc.nbytes(o) for o in _outs(r["out"]))
    assert r["bytes"] == nbytes + io_bytes


def _old_covgrad_row_bytes(a, live_only):  # chip_smoke.covgrad_row_bytes, one input set
    return torch.unique(a[a >= 0] if live_only else a.clamp(min=0)).numel() * L * 4


@pytest.mark.parametrize("name", NAMES)
def test_work_with_data_counts_is_the_old_bound_arithmetic(name):
    """The arithmetic `chip_smoke.py` computed each bound with, written
    out here as it stood (the sources of the bound columns of `PERF.md`
    section 6), against the work function fed this input's counts."""
    _, inputs, *_ = CASES[name]
    args = inputs()
    if name.startswith("snis_covgrad_fwd"):
        h, beta, a, _, _, cg = args
        rows = torch.unique(a.clamp(min=0)).numel()
        f, n, b = sk.snis_fwd_work(B, S, L, P, cg, rows=rows)
        fwd_io = {False: B * S * 8 + B * L * 4, True: B * S * 16 + B * L * 8}
        assert b == _old_covgrad_row_bytes(a, False) + fwd_io[cg]
        assert f * n == (6 if cg else 2) * B * S * L
    elif name == "snis_covgrad_bwd":
        _, a, _ = args
        f, n, b = sk.snis_bwd_work(B, S, L, P, rows=torch.unique(a[a >= 0]).numel())
        assert b == _old_covgrad_row_bytes(a, True) + B * S * 8 + B * L * 4
        assert f * n == 2 * B * S * L
    elif name == "fused_sampler":
        f, n, b = fk.sampler_work(B, S, S, K, kappa_draws=10)
        assert b == B * K * 8 + B * S * 12 and f * n == 10 * K
    elif name == "mips_topk":
        f, n, b = mk.mips_topk_work(B, P, L, K)
        assert b == P * L * 4 + B * L * 4 + B * K * 8 and f * n == 2 * B * P * L
    elif name == "ivf_probe_topk":
        q, probe, lists, embs, k = args
        live = (lists >= 0).sum(dim=1)
        n_live = float(live[probe.long()].sum(dim=1).sum())
        f, n, b = ik.ivf_probe_work(B, L, probe.shape[1], lists.shape[1], k, live=n_live)
        old = (B * probe.shape[1] * lists.shape[1] * 4 + n_live * 4 * L + q.numel() * 4
               + probe.numel() * 4 + B * k * 8)
        assert b == old and f * n == 2 * L * n_live
        assert 0 < n_live < B * probe.shape[1] * lists.shape[1]
    else:
        table, idx = args
        v, d = table.shape
        live = idx[idx >= 0].clamp(max=v - 1)
        rows = torch.unique(live).numel()
        f, n, b = ek.embedding_bag_work(*idx.shape, v, d, 4, rows=rows, live=live.numel())
        assert b == rows * d * 4 + idx.numel() * 4 + idx.shape[0] * d * 4
        assert f * n == live.numel() * d
        assert rows < min(idx.numel(), v)


# ---------------------------------------------------------------------------
# DTensors, inputs that require grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_a_dtensor_input_raises(monkeypatch, name):
    """No mesh reaches K1-K8, so none has a sharding rule: DTensor
    refuses the call, and neither the kernel nor its plain version
    runs."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_debug_mesh

    op, inputs, _, mod, plain = CASES[name]
    monkeypatch.setattr(mod._ref, plain, _refuse)
    args = _meta(inputs())
    with make_debug_mesh(1, 1) as mesh:
        dargs = tuple(DTensor.from_local(a, mesh, [Replicate(), Replicate()], run_check=False)
                      if isinstance(a, torch.Tensor) else a for a in args)
        with pytest.raises(NotImplementedError, match="sharding strateg"):
            op(*dargs)


def test_inputs_that_require_grad_give_constant_outputs():
    """`mips_topk` on an h that requires grad, K8 on a table being
    trained, the sampler on scores that do: the outputs require no grad
    and no autograd warning is raised, on the CPU as on the card."""
    h, beta = _covgrad_inputs()[:2]
    h.requires_grad_(True)
    table, idx = _eb_inputs()
    table.requires_grad_(True)
    _, eps, ids, scores, *_ = _sampler_inputs()
    scores.requires_grad_(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        outs = [*mo.mips_topk(h, beta, K), eo.embedding_bag(table, idx),
                eo.embedding_bag(table, idx, "mean"),
                *fo.fused_mixture_sample(7, ids, scores, num_samples=S, epsilon=eps,
                                         num_items=P, sample_tile=8)]
    assert not any(o.requires_grad for o in outs)
