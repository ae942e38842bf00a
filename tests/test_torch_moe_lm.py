"""The LM arches the models slice adds to the port (olmoe-1b-7b,
arctic-480b, granite-8b, mistral-large-123b, beside gemma2-2b): serving
and training through their SMOKE_CONFIGs, on the CPU.

* The port's mirror of the reference's `test_lm_smoke_decode_matches_forward`
  (`tests/test_models.py`) for every LM arch: prefill's last logits
  against `forward` within rtol 3e-4 / atol 3e-4, one decode step against
  `forward` on the extended tokens within rtol 3e-3 / atol 3e-3 (the
  reference's tolerances; MoE at capacity factor 8, no drops, as there).
* The LM route under capacity drops: OLMoE at capacity factor 0.5 serves
  3 prompts at max_batch 2 through both packages' engines (the short
  batch padded with a zero-token prompt, whose tokens take capacity): the
  same generated tokens. The reference's weights and IVF index are
  carried across.
* The serve and train CLIs for the four arches with ``--device cpu``.
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve import CoalescePolicy as JaxCoalescePolicy  # noqa: E402
from repro.serve import LMGenerateRoute as JaxLMRoute  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import ivf_index_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import CoalescePolicy, LMGenerateRoute, ServingEngine  # noqa: E402
from repro_torch.serve import planner as planner_mod  # noqa: E402

LM_ARCHS = ["mistral-large-123b", "granite-8b", "gemma2-2b", "olmoe-1b-7b", "arctic-480b"]
NEW_ARCHS = ["mistral-large-123b", "granite-8b", "olmoe-1b-7b", "arctic-480b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_decode_matches_forward(arch):
    cfg = get_arch(arch).SMOKE_CONFIG
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)  # no drops
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    b, s = 2, 12
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    cache = lm.init_cache(cfg, b, s + 2)
    pl_logits, cache = lm.prefill(cfg, params, toks, cache)
    with torch.no_grad():
        ref_logits, _ = lm.forward(cfg, params, toks)
    np.testing.assert_allclose(pl_logits.numpy(), ref_logits[:, -1].numpy(), rtol=3e-4, atol=3e-4)
    nxt = torch.argmax(pl_logits, -1)
    d_logits, cache = lm.decode_step(cfg, params, nxt, cache)
    with torch.no_grad():
        ref2, _ = lm.forward(cfg, params, torch.cat([toks, nxt[:, None]], dim=1))
    np.testing.assert_allclose(d_logits.numpy(), ref2[:, -1].numpy(), rtol=3e-3, atol=3e-3)


def test_moe_route_with_drops_generates_the_reference_tokens(monkeypatch):
    """Capacity is shared by the batch's rows, padding rows included: both
    engines pad the short batch alike and give the same tokens."""
    over = dict(capacity_factor=0.5)
    jcfg = dataclasses.replace(jax_get_arch("olmoe-1b-7b").SMOKE_CONFIG, **over)
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").SMOKE_CONFIG, **over)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    kw = dict(prompt_len=6, gen_len=4, max_batch=2, top_k=4)
    jroute = JaxLMRoute(jcfg, jparams, **kw)
    st = jroute.planner.index_state
    index = ivf_index_from_numpy(np.asarray(st.centroids), np.asarray(st.lists),
                                 np.asarray(st.list_embs), jcfg.vocab_size)
    monkeypatch.setattr(planner_mod, "build_ivf", lambda *a, **k: index)
    route = LMGenerateRoute(cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jparams)),
                            device="cpu", **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (6,)).astype(np.int32) for _ in range(3)]
    fixed = lambda measured, batch_no: 0.001  # noqa: E731
    engines = (JaxEngine(jroute, JaxCoalescePolicy(max_batch=2, max_wait_s=0.01),
                         service_model=fixed),
               ServingEngine(route, CoalescePolicy(max_batch=2, max_wait_s=0.01),
                             service_model=fixed))
    recs = []
    for eng in engines:
        eng.warmup()
        for p in prompts:
            eng.submit(p, 0.0)
        recs.append(eng.drain())
    assert [r.batch_size for r in recs[1]] == [2, 2, 1]
    assert [list(r.result) for r in recs[1]] == [list(r.result) for r in recs[0]]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_runs_the_lm_arch_on_the_cpu(capsys, arch):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--prompt-len", "6",
                    "--gen-len", "3", "--max-batch", "2"])
    assert f"{arch} on cpu: 3 requests in 2 batches" in capsys.readouterr().out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_cli_runs_the_lm_arch_on_the_cpu(capsys, arch):
    """The reference's `_train_lm` recipe, one ``step i: loss=... (... ms)``
    line a step, near log(vocab) for random weights."""
    train_cli.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={arch} family=lm (smoke scale on cpu)"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2
    vocab = get_arch(arch).SMOKE_CONFIG.vocab_size
    for i, ln in enumerate(steps):
        m = re.fullmatch(rf"step {i}: loss=(\d+\.\d{{4}}) \(\d+ ms\)", ln)
        assert m, ln
        assert abs(float(m.group(1)) - np.log(vocab)) < 1.5
