"""What has to come out as not correct: the control (the reference put
in the program's place, its products in TF32, the precision below the
configurations' fp32) and each fault a cell can have, planted in the
program under the whole run of the harness, some only once set-up is
over, where only the window's steps can show them. On the CPU at a tiny
size, with the cells' own limits; one chip, so no exchange between chips
can be left out."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench import calibrate
from bench.tinycells import TINY, tiny_cell, tiny_run


def _over(numbers: dict, limits: dict) -> list[str]:
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("workload", list(TINY))
def test_control_fails_and_program_passes(workload):
    cell = tiny_cell(workload)
    line = calibrate.readings(cell, 2**31 + 99, True, 0.3, torch.device("cpu"))
    assert not _over(line["program"], cell.limits)
    assert _over(line["control"], cell.limits)
    if "half_batch" in line:
        assert _over(line["half_batch"], cell.limits)
    for fault in set(line) - {"seed", "program", "control"}:  # each planted in the reference
        assert _over(line[fault], cell.limits), fault


def _train_step_unchanged(orig):
    def step(self, seed, contexts, positives, eps, fault=None):
        params, state = self.params, self.opt_state
        out = orig(self, seed, contexts, positives, eps, fault)
        self.params, self.opt_state = params, state
        return out
    return step


def _train_step_half(orig):
    def step(self, seed, contexts, positives, eps, fault=None):
        n = contexts.shape[0] // 2
        return orig(self, seed, contexts[:n], positives[:n], eps, fault)
    return step


def _after_setup(workload: str = "fopo-paper.exact-b4096") -> int:
    """The number of steps a tiny training cell's set-up runs."""
    t = tiny_cell(workload).traffic
    return t["reference_steps"] + t["steps_per_call"]


def _train_step_stale_batch(orig):
    """From the window on, every step trains on the batch the window's
    first step had: inputs that are not refreshed."""
    after, kept = _after_setup(), {}

    def step(self, seed, contexts, positives, eps, fault=None):
        if self.step >= after:
            contexts, positives = kept.setdefault("batch", (contexts, positives))
        return orig(self, seed, contexts, positives, eps, fault)
    return step


def _resolve_stale_topk(orig, workload: str = "fopo-paper.exact-b4096"):
    """A plan whose retrieval, from the window on, hands back the top-K
    of the window's first step: a cached retrieval."""
    after = _after_setup(workload)

    def resolve(*args, **kwargs):
        plan = orig(*args, **kwargs)
        inner, calls, cache = plan.retriever, [0], {}

        def retriever(h, beta):
            calls[0] += 1
            if calls[0] <= after:
                return inner(h, beta)
            return cache.setdefault("top", inner(h, beta))
        return dataclasses.replace(plan, retriever=retriever)
    return staticmethod(resolve)


def _build_ivf_other_seed(orig):
    """The training route's IVF index built with another seed than the
    one the run gives it."""
    def build(*args, seed=0, **kwargs):
        return orig(*args, seed=seed + 1, **kwargs)
    return build


def _run_altered(orig):
    """An answer altered where it is produced: the first user's best id."""
    def run(self, batch):
        out = orig(self, batch)
        ids = out.indices.clone()
        ids[0, 0] = (ids[0, 0] + 1) % self.cfg.item_vocab
        return out._replace(indices=ids)
    return run


def _run_half(orig):
    """Half of each batch's answers left out."""
    def run(self, batch):
        out = orig(self, batch)
        n = out.indices.shape[0] // 2
        return out._replace(indices=out.indices[:n], scores=out.scores[:n])
    return run


def _run_stale(orig):
    """Each batch answered with the previous batch's answers."""
    last = {}

    def run(self, batch):
        out = orig(self, batch)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return run


FAULTS = {
    "state_unchanged": ("fopo-paper.exact-b4096", "repro_torch.train.trainer.FOPOTrainer",
                        "train_step", _train_step_unchanged),
    "half_batch_mean": ("fopo-paper.exact-b4096", "repro_torch.train.trainer.FOPOTrainer",
                        "train_step", _train_step_half),
    "stale_batch": ("fopo-paper.exact-b4096", "repro_torch.train.trainer.FOPOTrainer",
                    "train_step", _train_step_stale_batch),
    "stale_topk": ("fopo-paper.exact-b4096", "repro_torch.core.plan.ExecutionPlan", "resolve",
                   _resolve_stale_topk),
    "stale_topk_ivf": ("fopo-paper.ivf-b4096", "repro_torch.core.plan.ExecutionPlan", "resolve",
                       lambda orig: _resolve_stale_topk(orig, "fopo-paper.ivf-b4096")),
    "index_other_seed": ("fopo-paper.ivf-b4096", "repro_torch.mips.ivf", "build_ivf",
                         _build_ivf_other_seed),
    "answer_altered": ("sasrec.bulk-b4096", "repro_torch.serve.routes.RecsysMIPSRoute",
                       "run", _run_altered),
    "half_batch_left_out": ("sasrec.bulk-b4096", "repro_torch.serve.routes.RecsysMIPSRoute",
                            "run", _run_half),
    "stale_answers": ("sasrec.bulk-b4096", "repro_torch.serve.routes.RecsysMIPSRoute",
                      "run", _run_stale),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    import importlib

    workload, target, attr, wrap = FAULTS[fault]
    try:
        owner = importlib.import_module(target)  # a module's function
    except ModuleNotFoundError:
        mod, cls = target.rsplit(".", 1)
        owner = getattr(importlib.import_module(mod), cls)
    monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    result, lines = tiny_run(workload, seed=2**31 + 5)
    assert not result["correct"], lines
