"""The port's mixture of experts (`repro_torch.models.moe.moe_ffn`) and the
MoE LMs of `repro_torch.models.lm` (OLMoE's and Arctic's SMOKE_CONFIGs)
against the JAX reference, on the CPU, inputs and weights from numpy or
the reference's `init_params` carried across by `repro_torch.convert`.

`moe_ffn` is held at capacity factor 0.5 (half the assignments dropped,
dropped ones clamped onto slots that kept tokens own) and 8.0 (no drops),
in fp32 and bf16: the output, `aux_loss`, `dropped_frac` and the
gradients of sum(out * cotangent) + aux_loss in every input.

Tolerances:
* fp32 `moe_ffn` output and gradients: rtol 1e-5 / atol 1e-6 times the
  largest |value| (sums of terms of both signs, taken in another order);
  aux_loss rtol 1e-6; dropped_frac exact;
* bf16 `moe_ffn`: atol 2^-6 times the largest |value| (two bf16 ulps at
  the top binade: the expert products and the silu product are rounded
  to bf16 in both, their fp32 sums in another order), rtol 0;
* LM forward / loss / gradients in fp32: as `test_torch_lm_train.py`
  (loss rtol 1e-5; logits rtol 1e-5 / atol 1e-6 times max |logits|;
  gradients rtol 1e-4 / atol 1e-5); prefill and decode logits as
  `test_torch_lm.py` (rtol 1e-5 / atol 2e-5).

The Adam steps are in `test_torch_moe_train.py`, which shares this
file's set-up.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.moe import expert_ranks, moe_capacity, moe_ffn  # noqa: E402

T, D, E, K, F = 24, 16, 4, 2, 8
B, S = 4, 12
MOE_ARCHS = ["olmoe-1b-7b", "arctic-480b"]


def _moe_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((T, D)).astype(np.float32),
        (rng.standard_normal((D, E)) / 4).astype(np.float32),
        (rng.standard_normal((E, D, F)) / 4).astype(np.float32),
        (rng.standard_normal((E, D, F)) / 4).astype(np.float32),
        (rng.standard_normal((E, F, D)) / 3).astype(np.float32),
    ], rng.standard_normal((T, D)).astype(np.float32)


@functools.cache
def _jax_moe(dtype: str, cf: float):
    """(out, aux_loss, dropped_frac, grads of the 5 inputs), fp32 numpy."""
    args, cot = _moe_inputs()

    def f(a):
        out, aux = jax_moe_ffn(*a, num_experts_per_tok=K, capacity_factor=cf)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux["aux_loss"], (out, aux)

    jargs = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in args]
    (_, (out, aux)), grads = jax.value_and_grad(f, has_aux=True)(jargs)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return f32(out), float(aux["aux_loss"]), float(aux["dropped_frac"]), [f32(g) for g in grads]


def _port_moe(dtype: str, cf: float):
    args, cot = _moe_inputs()
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True) for a in args]
    out, aux = moe_ffn(*targs, num_experts_per_tok=K, capacity_factor=cf)
    loss = (out.float() * torch.from_numpy(cot)).sum() + aux["aux_loss"]
    grads = torch.autograd.grad(loss, targs)
    return out, aux, [g.float().numpy() for g in grads]


def _close(got, want, dtype: str, what: str):
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-6 * scale, err_msg=what)


@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype, cf):
    jout, jaux, jdrop, jgrads = _jax_moe(dtype, cf)
    out, aux, grads = _port_moe(dtype, cf)
    assert out.dtype == getattr(torch, dtype) and out.shape == (T, D)
    assert aux["aux_loss"].dtype == aux["dropped_frac"].dtype == torch.float32
    assert float(aux["dropped_frac"]) == jdrop
    assert (jdrop > 0) == (cf < 1)
    np.testing.assert_allclose(float(aux["aux_loss"].detach()), jaux, rtol=1e-6)
    _close(out.detach().float().numpy(), jout, dtype, "out")
    for name, g, jg in zip(("x", "router", "we_gate", "we_up", "we_down"), grads, jgrads):
        _close(g, jg, dtype, f"grad {name}")


def test_dropped_assignments_share_a_kept_slot():
    """At capacity factor 0.5 some dropped assignment is clamped onto slot
    capacity - 1 of an expert whose slot a kept token owns: the case an
    indexed assignment (in place of the accumulating dispatch) gets
    wrong. The tokens owning those slots match the reference."""
    args, _ = _moe_inputs()
    x, r = args[0], args[1]
    logits = x @ r
    top_e = np.argsort(-logits, axis=1, kind="stable")[:, :K].reshape(-1)
    cap = moe_capacity(T, K, 0.5, E)
    pos = np.array([(top_e[:i] == e).sum() for i, e in enumerate(top_e)])
    shared = {e for e, p in zip(top_e, pos) if p >= cap} & {
        e for e, p in zip(top_e, pos) if p == cap - 1}
    assert shared, "no dropped assignment meets a kept token's slot"
    owners = sorted({i // K for i, (e, p) in enumerate(zip(top_e, pos))
                     if e in shared and p == cap - 1})
    jout = _jax_moe("float32", 0.5)[0]
    out = _port_moe("float32", 0.5)[0].detach().numpy()
    assert np.abs(out[owners]).max() > 0
    np.testing.assert_allclose(out[owners], jout[owners], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,e", [(10, 4), (1000, 64), (131072, 64)])
def test_expert_ranks_are_the_reference_one_hot_cumsum(n, e):
    """`expert_ranks` (a stable sort) against the reference's rank, the
    cumsum of a one-hot minus one read at each entry's expert, up to
    OLMoE's prefill (8 x 2048 tokens, top 8, 64 experts)."""
    flat = np.random.default_rng(n).integers(0, e, n).astype(np.int32)
    onehot = jax.nn.one_hot(jnp.asarray(flat), e, dtype=jnp.int32)
    want = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    got = expert_ranks(torch.from_numpy(flat).long(), e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overflow_follows_token_major_order():
    """Every token routed to the same two experts: the first `capacity`
    tokens are kept, the rest dropped (zero output), the reference's
    order (token 0's k assignments, then token 1's, ...)."""
    t, d, e = 10, 4, 4
    x = torch.ones((t, d)) + torch.arange(t, dtype=torch.float32)[:, None] * 1e-3
    router = torch.zeros((d, e))
    router[:, 0], router[:, 1] = 2.0, 1.0
    g = torch.randn((e, d, 3), generator=torch.Generator().manual_seed(0))
    out, aux = moe_ffn(x, router, g, g, g.transpose(1, 2).contiguous(), num_experts_per_tok=2,
                       capacity_factor=1.0)
    cap = moe_capacity(t, 2, 1.0, e)
    assert cap == 5
    assert (out[:cap].abs().sum(1) > 0).all() and (out[cap:] == 0).all()
    assert float(aux["dropped_frac"]) == 0.5


# ---------------------------------------------------------------------------
# the MoE LMs
# ---------------------------------------------------------------------------

def _cfgs(arch: str, **kw):
    return (dataclasses.replace(get_arch(arch).SMOKE_CONFIG, **kw),
            dataclasses.replace(jax_get_arch(arch).SMOKE_CONFIG, **kw))


def _tokens(seed: int, vocab: int, b: int = B, s: int = S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@functools.cache
def _jax_params(arch: str):
    return jax_lm.init_params(_cfgs(arch)[1], jax.random.PRNGKey(0))


def _port_params(arch: str):
    return lm_params_from_numpy(jax.tree.map(np.asarray, _jax_params(arch)))


def _flat(tree) -> dict:
    def get(t):
        return np.asarray(t.float().numpy() if torch.is_tensor(t) else t, np.float32)

    out = {k: get(v) for k, v in tree.items() if k != "layers"}
    out.update({k: get(v) for k, v in tree["layers"].items()})
    return out


@functools.cache
def _jax_forward_and_grads(arch: str, cf: float | None):
    over = {} if cf is None else {"capacity_factor": cf}
    _, jcfg = _cfgs(arch, **over)
    x, y = (jnp.asarray(a) for a in _tokens(1, jcfg.vocab_size))

    @jax.jit
    def run(p):
        logits, aux = jax_lm.forward(jcfg, p, x)
        loss, grads = jax.value_and_grad(lambda q: jax_lm.loss_fn(jcfg, q, x, y))(p)
        return logits, aux, loss, grads

    logits, aux, loss, grads = run(_jax_params(arch))
    return np.asarray(logits), float(aux), float(loss), _flat(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", None), ("arctic-480b", None),
                                     ("olmoe-1b-7b", 0.5)],
                         ids=["olmoe", "arctic", "olmoe_drops"])
def test_forward_loss_and_gradients_match_reference(arch, cf):
    """`forward` (logits and the summed aux loss), `loss_fn` and every
    gradient leaf against `jax.grad`; OLMoE also at capacity factor 0.5,
    where tokens are dropped."""
    over = {} if cf is None else {"capacity_factor": cf}
    cfg, _ = _cfgs(arch, **over)
    jlogits, jaux, jloss, jgrads = _jax_forward_and_grads(arch, cf)
    x, y = (torch.from_numpy(a) for a in _tokens(1, cfg.vocab_size))
    params = _port_params(arch)
    expected = {"router", "we_gate", "we_up", "we_down"} | (
        {"w_gate", "w_up", "w_down"} if cfg.dense_residual else set())
    assert expected <= set(params["layers"])
    assert ("w_gate" in params["layers"]) == cfg.dense_residual
    with torch.no_grad():
        logits, aux = lm.forward(cfg, params, x)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5,
                               atol=1e-6 * np.abs(jlogits).max())
    loss, grads = lm.loss_and_grads(cfg, params, x, y)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-6)
    got = _flat(grads)
    assert sorted(got) == sorted(jgrads)
    for name in jgrads:
        np.testing.assert_allclose(got[name], jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)


@functools.cache
def _jax_serving(arch: str):
    """The reference's (prefill logits, decode logits) with 2 tokens of
    room, as numpy."""
    _, jcfg = _cfgs(arch)
    toks = jnp.asarray(_tokens(5, jcfg.vocab_size)[0])
    params = _jax_params(arch)
    cache = jax_lm.init_cache(jcfg, B, S + 2)
    pl, cache = jax.jit(lambda p, t, c: jax_lm.prefill(jcfg, p, t, c))(params, toks, cache)
    nxt = jnp.argmax(pl, -1)
    dl, _ = jax.jit(lambda p, t, c: jax_lm.decode_step(jcfg, p, t, c))(params, nxt, cache)
    return np.asarray(pl), np.asarray(dl)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """`prefill` over B x S tokens at the config's capacity factor, then one
    `decode_step` over B tokens at max(cf, 2): logits against the
    reference's."""
    cfg, _ = _cfgs(arch)
    jpl, jdl = _jax_serving(arch)
    params = _port_params(arch)
    toks = torch.from_numpy(_tokens(5, cfg.vocab_size)[0])
    cache = lm.init_cache(cfg, B, S + 2)
    pl, cache = lm.prefill(cfg, params, toks, cache)
    np.testing.assert_allclose(pl.numpy(), jpl, rtol=1e-5, atol=2e-5)
    nxt = torch.argmax(pl, -1)
    assert np.array_equal(nxt.numpy(), np.argmax(jpl, -1))
    dl, cache = lm.decode_step(cfg, params, nxt, cache)
    assert cache.length == S + 1
    np.testing.assert_allclose(dl.numpy(), jdl, rtol=1e-5, atol=2e-5)
