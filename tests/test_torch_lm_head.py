"""The port's FOPO LM head (`repro_torch.core.lm_head.fopo_lm_head_loss`)
against the JAX reference's, on the CPU, on shared draws.

Hidden states and the output embedding come from numpy with a seed; the
reward is `examples/lm_fopo_head.py`'s (tokens 100-199). The reference's
draws are its `MixtureProposal` over its own top-K from the same key its
loss uses, handed to the port as ``sample=``. The port's top-K (exact and
streaming) equals the reference's (scores rtol 1e-5 / atol 1e-6, ids as
sorted sets); the loss within rtol 1e-5 / atol 1e-7, the ESS rtol 1e-5,
the gradient of the hidden states rtol 1e-4 / atol 1e-6 times its
largest entry (sums over the samples, of both signs, in another order).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.lm_head import FopoLMHeadConfig as JaxHeadConfig  # noqa: E402
from repro.core.lm_head import fopo_lm_head_loss as jax_head_loss  # noqa: E402
from repro.core.proposals import MixtureProposal as JaxMixture  # noqa: E402
from repro.mips.exact import topk_exact as jax_topk_exact  # noqa: E402
from repro.mips.streaming import topk_streaming as jax_topk_streaming  # noqa: E402
from repro_torch.core import FopoLMHeadConfig, fopo_lm_head_loss  # noqa: E402
from repro_torch.core.proposals import ProposalSample  # noqa: E402
from repro_torch.mips.exact import topk_exact  # noqa: E402
from repro_torch.mips.streaming import topk_streaming  # noqa: E402
from test_torch_common import assert_topk_equal  # noqa: E402

N, D, V, S, K = 24, 16, 600, 48, 16
HEAD = dict(vocab_size=V, num_samples=S, top_k=K, epsilon=0.5, block_items=256)


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, D)).astype(np.float32),
            (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32))


def _jax_rewards(actions):
    return (actions[..., None] == jnp.arange(100, 200)).any(-1).astype(jnp.float32)


def _rewards(actions):
    return ((actions >= 100) & (actions < 200)).float()


@functools.cache
def _reference(retriever: str):
    """(its top-K, its draws as a port ProposalSample, loss, ESS, d loss /
    d hidden) at key 7."""
    hidden, emb = (jnp.asarray(a) for a in _inputs())
    cfg = JaxHeadConfig(retriever=retriever, **HEAD)
    key = jax.random.PRNGKey(7)
    (loss, aux), grad = jax.value_and_grad(
        lambda h: jax_head_loss(h, emb, _jax_rewards, key, cfg), has_aux=True)(hidden)
    if retriever == "exact":
        topk = jax_topk_exact(hidden, emb, K)
    else:
        topk = jax_topk_streaming(hidden, emb, K, cfg.block_items)
    sample = JaxMixture(V, cfg.epsilon).sample(key, topk.indices, topk.scores, S)
    port_sample = ProposalSample(*(torch.from_numpy(np.array(t)) for t in sample))
    return topk, port_sample, float(loss), float(aux["ess"]), np.asarray(grad)


@pytest.mark.parametrize("retriever", ["exact", "streaming"])
def test_loss_and_gradient_match_reference_on_its_draws(retriever):
    jtopk, sample, jloss, jess, jgrad = _reference(retriever)
    hidden, emb = (torch.from_numpy(a) for a in _inputs())
    if retriever == "exact":
        top = topk_exact(hidden, emb, K)
    else:
        top = topk_streaming(hidden, emb, K, HEAD["block_items"])
    assert_topk_equal(top, jtopk)
    cfg = FopoLMHeadConfig(retriever=retriever, **HEAD)
    h = hidden.clone().requires_grad_(True)
    loss, aux = fopo_lm_head_loss(h, emb, _rewards, 7, cfg, sample=sample)
    (grad,) = torch.autograd.grad(loss, h)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(aux["ess"]), jess, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-4, atol=1e-6 * np.abs(jgrad).max())


def test_own_draws_are_the_mixture_and_the_embedding_stays_frozen():
    """Without ``sample=`` the loss draws its own S actions a row from the
    mixture over its top-K (seeded: the same seed, the same loss), and no
    gradient reaches the output embedding (Assumption 1)."""
    hidden, emb = (torch.from_numpy(a) for a in _inputs())
    emb = emb.clone().requires_grad_(True)
    cfg = FopoLMHeadConfig(**HEAD)
    h = hidden.clone().requires_grad_(True)
    l1, aux = fopo_lm_head_loss(h, emb, _rewards, 11, cfg)
    l2, _ = fopo_lm_head_loss(h, emb, _rewards, 11, cfg)
    assert torch.equal(l1, l2) and 1.0 <= float(aux["ess"]) <= S
    grad_h, grad_e = torch.autograd.grad(l1, (h, emb), allow_unused=True)
    assert grad_e is None and torch.isfinite(grad_h).all() and float(grad_h.abs().max()) > 0
