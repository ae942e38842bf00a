"""FOPO-LM training of an AFMoE model (Trinity-Mini) through the
program's own step, `repro_torch.models.lm.make_train_step(cfg, optimizer,
"fopo", plan=...)` over an `ExecutionPlan` on ``retriever="ivf_pallas"``,
``fused`` and ``fused_sampler``, as a team would fine-tune an MoE LM on
logged token-level feedback.

Set-up makes, on the device, the frozen unembedding (the catalog) and a
pool of Zipf-skewed token sequences from the traffic's ``data_seed``,
builds the program's IVF index over the unembedding (deterministic
algorithms, as `fopo_train` does), draws the trainable weights from the
run's seed, and drives the first steps. Each step trains ``batch``
sequences of ``seq_len`` tokens: every position is a context, its next
token its positive. A step's time runs from one step's start to the next
on the device's clock (CUDA events, recorded while the device is idle
between steps); a unit is one step.

The judge follows two steps: the set-up's first, from the seed's
weights, and one run after the window from the state the window left
(the parameters copied to the host first, outside any timing). For each
the program records the MoE layers' inputs and selections and the final
hidden states of its proposal pass, the top-K its retrieval handed the
sampler, its ESS, and Adam's first moment and the parameters of
`afmoe.LEAVES` before and after (the gradient is (m1 - b1 m0) / (1 -
b1)). The program is freed, then `bench.reference.afmoe` runs the step in
fp32 from the same state on the same tokens and step seed, following the
recorded selections and top-K. Each recording is also checked by itself:
each selection against the top-k of sigmoid(z W_r) of its own recorded
input, each top-K against the reference's IVF probe (its own index, the
same items and seed) of the program's own hidden states.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from bench.harness import PhaseClock, bench_span, run_window
from bench.reference import afmoe as ref
from bench.reference import compare
from bench.reference import fopo as fopo_ref
from bench.reference import sasrec as ivf_ref
from bench.reference.precision import fp32_products
from bench.yardstick import gen, lm_gen, lm_work
from bench.yardstick.stats import percentile

__all__ = ["Run"]

STEP_SEED_STREAM, LOADER_STREAM, DATA_STREAM, INDEX_STREAM, WEIGHT_STREAM = 1000, 2, 1, 3, 4
INT32_MAX = 2**31 - 1
# no loss gap: the loss is a covariance over the few positions whose next token
# was drawn (about 20 of 16,384), near zero on some seeds, so its relative gap
# read up to 1.2 on the program's own runs; the hidden states, the ESS and the
# gradients carry the comparison
NUMBERS = ("topk_score_err", "topk_rank_gap", "route_gap", "hidden_gap", "ess_gap", "grad_gap",
           "change_gap")


def step_seed(seed: int, step: int) -> int:
    return gen.sub_seed(seed, STEP_SEED_STREAM + step) % INT32_MAX


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b|; 0 where both are zero."""
    num, den = _norm(a - b), _norm(b)
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _worse(a: float, b: float) -> float:
    return math.inf if math.isnan(a) or math.isnan(b) else max(a, b)


# the keys of the cell's configuration that a cut or the tiny size may set,
# each to the `AFMoEConfig` field it sets; every other field is the
# registry's `CONFIG` (`repro_torch/configs/trinity_mini.py`)
FIELDS = {
    "hidden_size": "d_model", "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
    "intermediate_size": "d_ff", "moe_intermediate_size": "moe_d_ff",
    "vocab_size": "vocab_size", "sliding_window": "sliding_window",
    "num_experts_published": "num_experts", "num_experts_per_tok": "num_experts_per_tok",
    "num_dense_layers": "num_dense_layers", "num_hidden_layers": "num_layers",
    "compute_dtype": "compute_dtype",
}


def program_config(c: dict):
    """The program's `AFMoEConfig` of the cell's configuration: the
    registry's `CONFIG` of ``c["name"]``, cut to the cell (its first
    ``num_hidden_layers`` layers, the held experts) and at the tiny size
    to its widths."""
    from repro_torch.configs import get_arch

    base = get_arch(c["name"]).CONFIG
    n = c["num_hidden_layers"]
    return dataclasses.replace(
        base, **{field: c[key] for key, field in FIELDS.items()},
        layer_types=tuple("full" if t == "full_attention" else "sliding"
                          for t in c["layer_types"][:n]),
        held_experts=tuple(c["held_experts"]))


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core.fopo import FOPOConfig
        from repro_torch.core.plan import ExecutionPlan
        from repro_torch.mips import ivf
        from repro_torch.models import lm
        from repro_torch.optim.optimizers import adam

        fp32_products()
        self.phases = PhaseClock(device)
        self.device, self.seed, self.config = device, seed, config
        c, t = config, traffic
        self.model = ref.Model.of({**c, "layer_types": [
            "full" if x == "full_attention" else "sliding" for x in c["layer_types"]]})
        self.cfg = program_config(c)
        route = t["route"]
        self.batch, self.seq_len = t["batch"], t["seq_len"]
        self.contexts = self.batch * self.seq_len
        self.lr = c["learning_rate"]
        self.fshape = fopo_ref.FopoShape(
            num_items=c["vocab_size"], embed_dim=c["hidden_size"], num_samples=c["num_samples"],
            top_k=c["top_k"], epsilon=c["epsilon"], learning_rate=self.lr,
            sample_tile=route["sample_tile"], batch=self.contexts)
        self.ivf = {k: route[k] for k in ("num_clusters", "n_probe", "kmeans_iters")}
        self.trace_seconds = t["trace_seconds"]
        data = t["data_seed"]
        self.index_seed = gen.sub_seed(data, INDEX_STREAM) % INT32_MAX
        g_data = gen.device_generator(device, data, DATA_STREAM)
        self.beta = lm_gen.clustered_unembedding(c["vocab_size"], c["hidden_size"],
                                                 t["unembed_clusters"], t["unembed_spread"],
                                                 g_data)
        self.pool = lm_gen.zipf_tokens(t["sequences"], self.seq_len, c["vocab_size"],
                                       t["zipf_a"], g_data)
        self.loader_seed = gen.sub_seed(seed, LOADER_STREAM)
        params = self._theta0()
        self.phases("inputs")
        with ivf_ref.deterministic():
            index = ivf.build_ivf(self.beta, self.ivf["num_clusters"],
                                  kmeans_iters=self.ivf["kmeans_iters"], seed=self.index_seed,
                                  device=device)
        self.phases("index")
        fopo = FOPOConfig(num_items=c["vocab_size"], num_samples=c["num_samples"],
                          top_k=c["top_k"], epsilon=c["epsilon"], retriever=route["retriever"],
                          fused=route["fused"], fused_sampler=route["fused_sampler"],
                          sample_tile=route["sample_tile"])
        plan = ExecutionPlan.resolve(fopo, retriever_kwargs={"index": index,
                                                             "n_probe": self.ivf["n_probe"]})
        del index
        # the plan's retriever, with the top-K it hands the sampler recorded
        # in a judged step
        self._topk: list | None = None
        inner = plan.retriever
        plan = dataclasses.replace(plan,
                                   retriever=lambda h, beta: self._recorded(inner(h, beta)))
        self.optimizer = adam(self.lr, in_place=True)
        self.params, self.opt_state = params, self.optimizer.init(params)
        self.train_step = lm.make_train_step(self.cfg, self.optimizer, "fopo", plan=plan,
                                             unembed=self.beta)
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self._steps = 0
        self._losses: list[float] = []
        self.phases("program")
        self.setup = self._judged_step(start=None)
        self.phases("first step")
        self._step()  # a second, unrecorded: the window's path
        self.phases("warm step")
        self.post = None

    # -- inputs ------------------------------------------------------------------
    def _theta0(self) -> dict:
        return lm_gen.afmoe_params(self.config,
                                   gen.device_generator(self.device, self.seed, WEIGHT_STREAM))

    def _batch(self, step: int) -> dict:
        rows = torch.from_numpy(np.asarray(gen.batch_rows(
            self.pool.shape[0], self.batch, self.loader_seed, step))).to(self.device)
        tokens = self.pool[rows]
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
        return {"tokens": tokens, "labels": labels}

    # -- the program's steps -----------------------------------------------------
    def _recorded(self, top):
        if self._topk is not None:
            self._topk.append((top.scores.detach().clone(), top.indices.detach().clone()))
        return top

    def _mark(self):
        if not self.cuda:
            self.marks.append(time.perf_counter())
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append(ev)

    def _step(self, record: dict | None = None):
        self._mark()
        batch = self._batch(self._steps)
        self.params, self.opt_state, loss, aux = self.train_step(
            self.params, self.opt_state, batch, step_seed(self.seed, self._steps), record=record)
        self._steps += 1
        return batch, loss, aux

    def _leaves(self, tree) -> dict:
        return {name: ref.leaf(tree, path).detach().clone() for name, path in ref.LEAVES.items()}

    def _judged_step(self, start) -> dict:
        """One recorded step. ``start`` is the state before it on the host
        (None: the seed's weights, Adam at zero)."""
        step = self._steps
        m0, v0 = self._leaves(self.opt_state["m"]), self._leaves(self.opt_state["v"])
        p0 = self._leaves(self.params)
        rec: dict = {}
        self._topk = []
        batch, _, aux = self._step(record=rec)
        topk, self._topk = self._topk, None
        m1 = self._leaves(self.opt_state["m"])
        host = lambda x: x.detach().to("cpu")  # noqa: E731
        return {
            "step": step, "start": start, "tokens": batch["tokens"], "labels": batch["labels"],
            "ess": float(aux["ess"]), "hidden": host(rec["hidden"]),
            "moe_inputs": [host(z) for z in rec["moe_inputs"]],
            "routes": [host(r) for r in rec["routes"]],
            "topk": [(host(s), host(i)) for s, i in topk],
            "m0": m0, "v0": v0, "p0": p0, "p1": self._leaves(self.params),
            "grad": {k: (m1[k] - fopo_ref.ADAM_B1 * m0[k]) / (1.0 - fopo_ref.ADAM_B1)
                     for k in m1},
        }

    # -- the window ----------------------------------------------------------------
    def run_unit(self) -> None:
        with bench_span("train"):
            _, loss, _ = self._step()
        self._losses.append(loss)

    def window_begin(self) -> None:
        self._first = len(self.marks)
        self._losses = []

    def window_end(self) -> dict:
        self._mark()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        marks = self.marks[self._first:]
        ms = [(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
              for a, b in zip(marks[:-1], marks[1:])]
        self.marks.clear()
        losses = [float(x) for x in self._losses]
        return {"step_ms": ms, "steps": len(ms),
                "nonfinite": int(sum(not np.isfinite(x) for x in losses)),
                "notes": {"step_ms_p50": percentile(ms, 50) if ms else None}}

    def end_to_end(self, win: dict) -> dict:
        return {"train_contexts_per_s": win["steps"] * self.contexts / win["elapsed_s"],
                "train_step_ms_p95": percentile(win["step_ms"], 95)}

    def attempted_failed(self, win: dict) -> tuple[int, int]:
        return win["steps"], win["nonfinite"]

    def counters(self, win: dict) -> dict:
        c = self.config
        return {"steps": win["steps"], "batch": self.contexts, "sequences": self.batch,
                "seq_len": self.seq_len, "embed_dim": c["hidden_size"],
                "num_samples": c["num_samples"], "top_k": c["top_k"],
                "n_probe": self.ivf["n_probe"], "num_clusters": self.ivf["num_clusters"],
                "lm": lm_work.LMShape.of(c, self.batch, self.seq_len, self.ivf["num_clusters"])}

    # -- the judge -------------------------------------------------------------------
    def release(self) -> None:
        self.train_step = self.optimizer = self.params = self.opt_state = None
        if self.cuda:
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        if self.post is None:
            start = {k: {n: t.to("cpu", copy=True) for n, t in g.items()}
                     if isinstance(g, dict) else g.to("cpu", copy=True)
                     for k, g in self.params.items()}
            self.post = self._judged_step(start)
        self.release()
        with torch.no_grad():
            return self._numbers(lambda seg: seg)

    def segments(self) -> list[dict]:
        return [self.setup] + ([self.post] if self.post is not None else [])

    def _params(self, seg: dict) -> dict:
        if seg["start"] is None:
            return self._theta0()
        return {k: {n: t.to(self.device) for n, t in g.items()} if isinstance(g, dict)
                else g.to(self.device) for k, g in seg["start"].items()}

    def _probe(self, precision: str = "fp32"):
        """The reference's IVF probe h -> (scores, ids) in ``precision``, its
        index built once (in fp32, as the program's)."""
        if not hasattr(self, "_ref_index"):
            with ivf_ref.deterministic():
                self._ref_index = ivf_ref.build_index(self.beta, self.ivf["num_clusters"],
                                                      self.index_seed, "fp32",
                                                      iters=self.ivf["kmeans_iters"])
        cents, lists = self._ref_index
        k, n_probe = self.fshape.top_k, self.ivf["n_probe"]
        return lambda h: ivf_ref.answers(h, cents, lists, self.beta, k, n_probe, precision,
                                         block=16)

    def reference(self, seg: dict, follow: bool = True, precision: str = "fp32",
                  fault: ref.Fault = ref.NO_FAULT, routes=None, frozen: bool = False,
                  keep_rows: float = 1.0) -> dict:
        """The reference's step over ``seg``, as a recording like the
        program's: following its selections and top-K where ``follow``,
        else drawing on its own (``routes`` handed in are followed). Below
        fp32 (the control) the head, stated fp32, computes in TF32. With
        ``keep_rows`` < 1 only that share of the sequences is rewarded,
        the rest left out of the estimator (the mean still over every
        context); the recording keeps ``seg``'s labels."""
        dev = self.device
        labels = seg["labels"]
        if keep_rows < 1.0:
            labels = labels.clone()
            labels[int(labels.shape[0] * keep_rows):] = -1
        params = self._params(seg)
        if follow:
            routes = [r.to(dev) for r in seg["routes"]]
        topk = tuple(x.to(dev) for x in seg["topk"][0]) if follow else None
        head = "fp32" if precision == "fp32" else "tf32"
        out = ref.step(self.model, self.fshape, params, seg["tokens"], labels, self.beta,
                       step_seed(self.seed, seg["step"]), topk=topk,
                       retrieve=self._probe(head), routes=routes, precision=precision,
                       head_precision=head, fault=fault)
        p1 = ({k: ref.leaf(params, p) for k, p in ref.LEAVES.items()} if frozen else
              ref.adam_leaves(params, out["grads"], seg["m0"], seg["v0"], seg["step"] + 1,
                              self.lr))
        del params
        return dict(seg, ess=out["ess"], hidden=out["hidden"],
                    moe_inputs=out["moe_inputs"], routes=out["routes"],
                    topk=[out["topk"]], grad=out["grads"], p1=p1)

    def _numbers(self, as_program) -> dict:
        """The judged numbers with ``as_program(seg)`` in the program's place."""
        dev = self.device
        num = dict.fromkeys(NUMBERS, 0.0)
        probe = self._probe()
        for seg in self.segments():
            prog = as_program(seg)
            if (len(prog["topk"]) != 1 or len(prog["routes"]) != len(prog["moe_inputs"])
                    or prog["hidden"].shape != (self.contexts, self.config["hidden_size"])):
                return dict.fromkeys(NUMBERS, math.inf)
            h_prog = prog["hidden"].to(dev).float()
            top = tuple(x.to(dev) for x in prog["topk"][0])
            e, g = compare._topk_numbers(top, h_prog, probe(h_prog)[0], self.beta)
            num["topk_score_err"] = _worse(num["topk_score_err"], e)
            num["topk_rank_gap"] = _worse(num["topk_rank_gap"], g)
            params = self._params(seg)
            routers = [params["moe_layers"]["router"][j] for j in range(len(prog["routes"]))]
            num["route_gap"] = _worse(num["route_gap"], ref.route_gap(
                self.model, routers, [z.to(dev) for z in prog["moe_inputs"]],
                [r.to(dev) for r in prog["routes"]]))
            del params, routers
            want = self.reference(prog)
            num["hidden_gap"] = _worse(num["hidden_gap"], _gap(h_prog, want["hidden"]))
            num["ess_gap"] = _worse(num["ess_gap"], _rel(prog["ess"], want["ess"]))
            for k, g_ref in want["grad"].items():
                g_prog = prog["grad"][k].to(dev)
                num["grad_gap"] = _worse(num["grad_gap"], _gap(g_prog, g_ref))
            change = _norm(torch.cat([(prog["p1"][k].to(dev) - prog["p0"][k]).flatten()
                                      for k in ref.LEAVES]))
            change_ref = _norm(torch.cat([(want["p1"][k] - prog["p0"][k]).flatten()
                                          for k in ref.LEAVES]))
            num["change_gap"] = _worse(num["change_gap"],
                                       abs(change - change_ref) / max(change_ref, 1e-30))
        return num

    def calibration(self, control: bool, seconds: float) -> dict:
        """The readings the limits are set from: the program's numbers after
        a window of ``seconds``; with ``control`` also the control's (the
        reference in float8 e4m3 in the program's place) and those of
        faults planted in the reference put there: the state left
        unchanged, half of the batch left out (the second sequence's
        rewards dropped), RoPE on the full layers, the window on the full
        layers, another device's experts computed, and stale routing (each
        judged step routed as the other one was)."""
        run_window(self, seconds)
        line = {"program": self.judge()}
        if control:
            with torch.no_grad():
                segs = self.segments()
                other = {id(s): segs[1 - i] for i, s in enumerate(segs)}
                held = self.model.held
                line["control"] = self._numbers(
                    lambda seg: self.reference(seg, False, "fp8"))
                line["state_unchanged"] = self._numbers(
                    lambda seg: self.reference(seg, False, frozen=True))
                line["half_batch"] = self._numbers(
                    lambda seg: self.reference(seg, False, keep_rows=0.5))
                for name, fault in (("rope_on_full", ref.Fault(rope_on_full=True)),
                                    ("window_on_full", ref.Fault(window_on_full=True)),
                                    ("other_experts", ref.Fault(held_shift=held[1] - held[0]))):
                    line[name] = self._numbers(lambda seg, f=fault: self.reference(seg, False,
                                                                                   fault=f))
                line["stale_routing"] = self._numbers(
                    lambda seg: self.reference(seg, False, routes=[
                        r.to(self.device) for r in other[id(seg)]["routes"]]))
        return line
