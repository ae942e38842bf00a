"""The port's LM serving half (`repro_torch.models.lm`: prefill and decode
with the KV cache) against the JAX reference at Gemma-2's SMOKE_CONFIG
(4 layers, d 64, 4 heads over 2 KV heads, window 8 on even layers,
soft-caps 50 / 30, tied embedding, tanh gelu; fp32), on the CPU, with
the reference's weights carried across by `repro_torch.convert`.

Both switches of `use_flash_kernel` are held: False runs the chunked
plain-torch attention on both sides, True the flash-attention wrapper
(here its plain version; the reference's Pallas kernel in interpret
mode). A 12-token prompt fills 12 of 15 cache slots; three greedy
decode steps follow. Tolerances: logits, hidden states and the cache
within rtol 1e-5 / atol 2e-5 (fp32 matmuls through 4 layers, summed in
another order).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import kv_cache_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402

B, S, MAX_LEN, STEPS = 2, 12, 15, 3


def _cfgs(flash: bool):
    cfg = dataclasses.replace(get_arch("gemma2-2b").SMOKE_CONFIG, use_flash_kernel=flash)
    jcfg = dataclasses.replace(jax_get_arch("gemma2-2b").SMOKE_CONFIG, use_flash_kernel=flash)
    return cfg, jcfg


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "kernel"])
def test_prefill_and_decode_match_reference(flash):
    cfg, jcfg = _cfgs(flash)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    calls = flash_ref.flash_attention_ref.calls

    jcache = jax_lm.init_cache(jcfg, B, MAX_LEN)
    jlogits, jcache = jax_lm.prefill(jcfg, jparams, jnp.asarray(toks), jcache)
    jhidden, _ = jax_lm.prefill(jcfg, jparams, jnp.asarray(toks),
                                jax_lm.init_cache(jcfg, B, MAX_LEN), return_hidden=True)
    cache = lm.init_cache(cfg, B, MAX_LEN)
    logits, cache = lm.prefill(cfg, params, torch.from_numpy(toks), cache)
    hidden, _ = lm.prefill(cfg, params, torch.from_numpy(toks),
                           lm.init_cache(cfg, B, MAX_LEN), return_hidden=True)
    # one launch of the attention per layer and prefill on the kernel path
    assert flash_ref.flash_attention_ref.calls - calls == (2 * cfg.num_layers if flash else 0)
    assert logits.shape == (B, cfg.vocab_size) and hidden.shape == (B, cfg.d_model)
    _close(logits, jlogits)
    _close(hidden, jhidden)
    assert cache.length == int(jcache.length) == S
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)

    nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for _ in range(STEPS):
        jlogits, jcache = jax_lm.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache)
        logits, cache = lm.decode_step(cfg, params, torch.from_numpy(nxt.copy()), cache)
        _close(logits, jlogits)
        assert cache.length == int(jcache.length)
        _close(cache.k, jcache.k)
        _close(cache.v, jcache.v)
        nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    assert cache.length == S + STEPS


def test_decode_from_a_carried_cache_matches_reference():
    """A decode step on the reference's own cache, carried across by
    `convert.kv_cache_from_numpy`, returning the hidden state."""
    cfg, jcfg = _cfgs(False)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(2))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    _, jcache = jax_lm.prefill(jcfg, jparams, jnp.asarray(toks),
                               jax_lm.init_cache(jcfg, B, MAX_LEN))
    cache = kv_cache_from_numpy(np.asarray(jcache.k), np.asarray(jcache.v), jcache.length)
    tok = np.array([3, 500], dtype=np.int32)
    jh, _ = jax_lm.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, return_hidden=True)
    h, cache = lm.decode_step(cfg, params, torch.from_numpy(tok), cache, return_hidden=True)
    _close(h, jh)
    assert cache.length == S + 1


def test_params_and_cache_have_the_reference_layout():
    cfg, jcfg = _cfgs(True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == shapes["layers"]
    assert tuple(params["embed"].shape) == shapes["embed"] and "unembed" not in params
    assert tuple(params["final_norm"].shape) == shapes["final_norm"]
    assert all(t.dtype == torch.float32 for t in params["layers"].values())
    n = sum(t.numel() for t in params["layers"].values()) + params["embed"].numel() + cfg.d_model
    assert n == cfg.param_count() == jcfg.param_count()
    cache = lm.init_cache(cfg, 3, 9)
    assert tuple(cache.k.shape) == tuple(jax_lm.init_cache(jcfg, 3, 9).k.shape)
    assert cache.length == 0
    full = get_arch("gemma2-2b").CONFIG
    assert full.param_count() == jax_get_arch("gemma2-2b").CONFIG.param_count()
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_arch("gemma2-2b").CONFIG)


def test_layer_windows_alternate_as_the_reference_selects():
    cfg, _ = _cfgs(False)
    assert [lm.layer_window(cfg, i) for i in range(4)] == [8, None, 8, None]
    plain = dataclasses.replace(cfg, local_global_alternating=False)
    assert [lm.layer_window(plain, i) for i in range(2)] == [8, 8]
    assert lm.layer_window(dataclasses.replace(plain, sliding_window=None), 0) is None


def test_mixture_of_experts_waits_for_the_models_slice():
    """The models slice has landed: Gemma-2's SMOKE_CONFIG made a mixture
    of 4 experts (top 2) has the reference's MoE leaves and shapes (and no
    dense MLP), a positive aux loss, and prefill's last logits equal to
    `forward`'s (the same B x S tokens routed; rtol 1e-5 / atol 2e-5)."""
    over = dict(num_experts=4, num_experts_per_tok=2)
    cfg = dataclasses.replace(get_arch("gemma2-2b").SMOKE_CONFIG, **over)
    jcfg = dataclasses.replace(jax_get_arch("gemma2-2b").SMOKE_CONFIG, **over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k), jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == {
        k: v.shape for k, v in jshapes["layers"].items()}
    assert "w_gate" not in params["layers"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        logits, aux = lm.forward(cfg, params, toks)
    assert float(aux) > 0
    last, _ = lm.prefill(cfg, params, toks, lm.init_cache(cfg, B, MAX_LEN))
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), rtol=1e-5, atol=2e-5)
