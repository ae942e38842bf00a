"""The FOPO-LM cell (`trinity-mini.fopo-lm-s8k`) at its tiny size on the
CPU: the program's recordings the judge follows, and each fault planted
in the program under the whole run of the harness coming out as not
correct: the state left unchanged, half of the batch left out (the
second sequence's rewards dropped), RoPE on the full layers, the window
on the full layers, another device's experts computed, and routing
reused from an earlier call. The cell's program configuration is the
registry's, cut as the configuration file says."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from bench.drivers.fopo_lm import program_config
from bench.harness import ROOT
from bench.reference import afmoe as ref
from bench.tinycells import tiny_driver, tiny_run

CELL = "trinity-mini.fopo-lm-s8k"


def test_judged_steps_record_what_the_judge_follows():
    run = tiny_driver(CELL, 2**31 + 23)
    run.judge()
    setup, post = run.segments()
    assert setup["step"] == 0 and post["step"] == 2 + 0  # set-up ran two steps, no window
    for seg in (setup, post):
        n_moe = run.config["num_hidden_layers"] - run.config["num_dense_layers"]
        assert len(seg["topk"]) == 1 and len(seg["routes"]) == len(seg["moe_inputs"]) == n_moe
        assert seg["hidden"].shape == (run.contexts, run.config["hidden_size"])
        assert set(seg["grad"]) == set(ref.LEAVES)
    assert post["start"] is not None and not torch.equal(post["p0"]["full_wq"],
                                                         setup["p0"]["full_wq"])


def test_cell_config_is_the_registry_one_cut():
    from repro_torch.configs.trinity_mini import CONFIG

    c = json.loads((ROOT / "bench" / "configs" / "trinity-mini.json").read_text())
    n, held = c["num_hidden_layers"], tuple(c["held_experts"])
    assert program_config(c) == dataclasses.replace(
        CONFIG, num_layers=n, layer_types=CONFIG.layer_types[:n], held_experts=held)
    # the published keys the program takes from the registry, not the file
    for key, field in (("rope_theta", "rope_theta"), ("rms_norm_eps", "rms_eps"),
                       ("route_norm", "route_norm"), ("route_scale", "route_scale"),
                       ("num_shared_experts", "num_shared_experts"),
                       ("tie_word_embeddings", "tie_embeddings"), ("hidden_act", "gated_act")):
        assert c[key] == getattr(CONFIG, field), key
    assert c["layer_types"] == [t + "_attention" for t in CONFIG.layer_types]
    assert (n, c["num_hidden_layers_published"]) == (12, CONFIG.num_layers)
    assert held[1] - held[0] == c["num_experts"] and sorted(c["reduced"]) == [
        "num_experts", "num_hidden_layers"]


def _unchanged(orig):
    def adam(*a, **kw):
        opt = orig(*a, **kw)
        return opt._replace(update=lambda grads, state, params: (params, state))
    return adam


def _half_batch(orig):
    """Every step's second half of the sequences left out of the
    estimator: their next tokens never rewarded."""
    def make(*a, **kw):
        step = orig(*a, **kw)

        def half(params, opt_state, batch, seed, **k):
            labels = batch["labels"].clone()
            labels[labels.shape[0] // 2:] = -1
            return step(params, opt_state, dict(batch, labels=labels), seed, **k)
        return half
    return make


def _rope_everywhere(orig):
    def uses_rope(cfg, i):
        return True
    return uses_rope


def _window_everywhere(orig):
    def window(cfg, i):
        return cfg.sliding_window
    return window


def _other_experts(orig):
    def moe(x, layer, *, held, **kw):
        n = held[1] - held[0]
        return orig(x, layer, held=(held[0] + n, held[1] + n), **kw)
    return moe


def _stale_routing(orig):
    """From the third call of each router on, its first selection."""
    kept: dict = {}

    def route(x, router_w, **kw):
        key = (router_w.data_ptr(), x.shape[0])
        calls = kept.setdefault(key, [])
        calls.append(None)
        out = orig(x, router_w, **kw)
        if len(calls) == 1:
            kept[key + ("first",)] = out
        return out if len(calls) < 3 else kept[key + ("first",)]
    return route


FAULTS = {
    "state_unchanged": ("repro_torch.optim.optimizers", "adam", _unchanged),
    "half_batch": ("repro_torch.models.lm", "make_train_step", _half_batch),
    "rope_on_full": ("repro_torch.models.lm", "_uses_rope", _rope_everywhere),
    "window_on_full": ("repro_torch.models.lm", "layer_window", _window_everywhere),
    "other_experts": ("repro_torch.models.lm", "afmoe_moe", _other_experts),
    "stale_routing": ("repro_torch.models.moe", "afmoe_route", _stale_routing),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_in_the_program_is_not_correct(fault, monkeypatch):
    import importlib

    target, attr, wrap = FAULTS[fault]
    owner = importlib.import_module(target)
    monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    result, lines = tiny_run(CELL, seed=2**31 + 5)
    assert not result["correct"], lines
