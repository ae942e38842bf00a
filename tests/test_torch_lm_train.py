"""The port's LM training half (`repro_torch.models.lm`: `forward`,
`loss_fn`, `make_train_step`) against the JAX reference, on the CPU: `forward`,
`loss_fn` and the gradients here, the training steps in
`test_torch_lm_trajectory.py` (which shares this file's set-up).

The model is Gemma-2's SMOKE_CONFIG cut to 2 layers (one local layer
with window 8, one global; d 64, 4 heads over 2 KV heads of 16, vocab
512; soft-caps 50 / 30; tied embedding), weights from the reference's
`init_params` carried across by `repro_torch.convert`, tokens from numpy
with a seed. `use_flash_kernel=True` runs the port's flash attention
(its plain versions here, forward and backward) against the reference's
Pallas kernels in interpret mode; False the chunked attention on both
sides. The reference computes both attentions of an alternating layer
and selects one; the port computes only the one it uses, so the gradient
parity shows the unselected branch contributes nothing.

Tolerances:
* fp32 loss: rtol 1e-5 / atol 1e-6; fp32 logits: rtol 1e-5 / atol 1e-6
  times max |logits| (a logit is a sum of terms of both signs, so its
  fp32 error in another order scales with the terms, not with the sum);
* fp32 gradients: rtol 1e-4 / atol 1e-5 (the backward's sums, over B x S
  and the vocabulary, in another order).
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
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402

LAYERS, B, S, LR = 2, 4, 32, 1e-3
LEAVES = ("embed", "final_norm", "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
          "w_gate", "w_up", "w_down")


def _cfgs(flash: bool, **kw):
    over = dict(num_layers=LAYERS, use_flash_kernel=flash, **kw)
    return (dataclasses.replace(get_arch("gemma2-2b").SMOKE_CONFIG, **over),
            dataclasses.replace(jax_get_arch("gemma2-2b").SMOKE_CONFIG, **over))


def _tokens(seed: int) -> tuple[np.ndarray, np.ndarray]:
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _flat(tree) -> dict:
    """{leaf name: float32 numpy} of an LM tree (numpy, JAX or torch)."""
    def get(t):
        return np.asarray(t.float().numpy() if torch.is_tensor(t) else t, np.float32)

    out = {k: get(tree[k]) for k in ("embed", "final_norm")}
    out.update({k: get(v) for k, v in tree["layers"].items()})
    return out


def _dtypes(tree) -> dict:
    name = lambda t: str(t.dtype).replace("torch.", "")  # noqa: E731
    out = {k: name(tree[k]) for k in ("embed", "final_norm")}
    out.update({k: name(v) for k, v in tree["layers"].items()})
    return out


@functools.cache
def _jax_params(dtype: str = "float32"):
    _, jcfg = _cfgs(True, dtype=dtype)
    return jax_lm.init_params(jcfg, jax.random.PRNGKey(0))


@functools.cache
def _jax_forward_and_grads(flash: bool):
    """(logits, loss, grads) of the reference, as numpy."""
    _, jcfg = _cfgs(flash)
    x, y = (jnp.asarray(a) for a in _tokens(1))

    @jax.jit
    def run(p):
        logits, _ = jax_lm.forward(jcfg, p, x)
        loss, grads = jax.value_and_grad(lambda q: jax_lm.loss_fn(jcfg, q, x, y))(p)
        return logits, loss, grads

    logits, loss, grads = run(_jax_params())
    return np.asarray(logits), float(loss), _flat(jax.tree.map(np.asarray, grads))


def _port_params(dtype: str = "float32"):
    return lm_params_from_numpy(jax.tree.map(np.asarray, _jax_params(dtype)))


@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "kernel"])
def test_forward_and_loss_match_reference(flash):
    cfg, _ = _cfgs(flash)
    jlogits, jloss, _ = _jax_forward_and_grads(flash)
    x, y = (torch.from_numpy(a) for a in _tokens(1))
    params = _port_params()
    with torch.no_grad():
        logits, aux = lm.forward(cfg, params, x)
        loss = lm.loss_fn(cfg, params, x, y)
    assert logits.shape == (B, S, cfg.vocab_size) and logits.dtype == torch.float32
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5,
                               atol=1e-6 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "kernel"])
def test_gradients_match_reference(flash):
    """Every gradient leaf against `jax.grad(loss_fn)`. On the kernel
    path each layer runs the attention's forward twice (remat) and its
    backward once."""
    cfg, _ = _cfgs(flash)
    _, jloss, jgrads = _jax_forward_and_grads(flash)
    x, y = (torch.from_numpy(a) for a in _tokens(1))
    fwd, bwd = flash_ref.flash_attention_ref.calls, flash_ref.flash_attention_bwd_ref.calls
    loss, grads = lm.loss_and_grads(cfg, _port_params(), x, y)
    if flash:
        assert flash_ref.flash_attention_ref.calls - fwd == 2 * LAYERS
        assert flash_ref.flash_attention_bwd_ref.calls - bwd == LAYERS
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-6)
    got = _flat(grads)
    assert sorted(got) == sorted(LEAVES) == sorted(jgrads)
    for name in LEAVES:
        np.testing.assert_allclose(got[name], jgrads[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_remat_does_not_change_the_numbers():
    x, y = (torch.from_numpy(a) for a in _tokens(2))
    params = _port_params()
    out = {}
    for remat in (True, False):
        cfg, _ = _cfgs(True, remat=remat)
        out[remat] = lm.loss_and_grads(cfg, params, x, y)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(optim.optimizers.tree_leaves(out[True][1]),
                    optim.optimizers.tree_leaves(out[False][1])):
        assert torch.equal(a, b)
