"""FOPO training through the program's trainer, `repro_torch.train
.FOPOTrainer`, as a team would run it over logged sessions.

Set-up makes the catalog, the contexts, theta0 and the positives on the
device from the seed, builds one trainer and drives it through the
reference's first steps with the window's own call (`train`) and feed
(its loader); that same trainer then runs the window,
``steps_per_call`` steps a call, each step ending in the trainer's own
wait for the device. A step's time runs from one batch request of the
loader to the next, on the device's clock (CUDA events, recorded while
the device is idle between steps).

Every call, the set-up's and the window's, keeps a record of its first
steps: the state before them (W and Adam's moments, copied at the
loader's batch request, while the device is idle), the top-K that each
step's retrieval handed its sampler, their losses and effective sample
sizes, and the state after them. The judge frees the trainer and has
`bench.reference.fopo` follow the set-up's first steps from theta0 and
the first steps of the window's last call from the state the program
had before them, on the same batches and step seeds, drawing from the
recorded top-K: near-equal scores that 3xTF32 and fp32 order otherwise
would otherwise swap their Gumbel noise and change draws, and with them
the rewards, which no product's precision explains. Each recorded top-K
is checked by itself against the reference's top-K of its own h at that
step.

The traffic may name a ``data_seed``: the catalog and the contexts
(and on the IVF route the index) then come from it, the same for every
run, and the run's seed draws theta0, the positives, the batches'
order and the step seeds. The traffic may name a ``route``, merged
over the configuration's. On
``retriever="ivf_pallas"`` set-up builds the program's IVF index over
the catalog (``num_clusters`` lists, ``kmeans_iters`` Lloyd iterations,
seeded from the data's seed) under torch's deterministic algorithms and
hands it to the trainer, which probes ``n_probe`` lists a context; the
reference builds its own index from the same items and seed
(`bench.reference.sasrec.build_index`, the same algorithms) and its
probe's top-K is what each recorded top-K is checked against. Elsewhere
that is the exact top-K over the whole catalog.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from bench.harness import PhaseClock, bench_span, run_window
from bench.reference import compare
from bench.reference import fopo as ref
from bench.reference import sasrec as ivf_ref
from bench.reference.precision import fp32_products
from bench.yardstick import gen, work
from bench.yardstick.stats import percentile

__all__ = ["Run"]

STEP_SEED_STREAM, LOADER_STREAM, DATA_STREAM, INDEX_STREAM = 1000, 2, 1, 3
INT32_MAX = 2**31 - 1


class _Clock:
    """Marks on the device's clock where there is a card, else the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class _TimedLoader:
    """The trainer's loader, unchanged, with a clock mark and a call of
    ``on_batch`` at each batch request, and a span around it."""

    def __init__(self, loader, clock: _Clock, marks: list, on_batch):
        self._loader, self._clock, self._marks, self._on_batch = loader, clock, marks, on_batch

    def next_batch(self):
        self._marks.append(self._clock.mark())
        self._on_batch()
        with bench_span("loader"):
            return self._loader.next_batch()

    def __getattr__(self, name):
        return getattr(self._loader, name)


def step_seed(seed: int, step: int) -> int:
    return gen.sub_seed(seed, STEP_SEED_STREAM + step) % INT32_MAX


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core.fopo import FOPOConfig
        from repro_torch.data import SessionDataset
        from repro_torch.train import FOPOTrainer, TrainerConfig

        fp32_products()
        self.phases = PhaseClock(device)
        self.device, self.seed = device, seed
        c, t = config, traffic
        route = {**c["route"], **t.get("route", {})}
        self.shape = ref.FopoShape(
            num_items=c["num_items"], embed_dim=c["embed_dim"], num_samples=c["num_samples"],
            top_k=c["top_k"], epsilon=c["epsilon"], learning_rate=c["learning_rate"],
            sample_tile=route["sample_tile"], batch=t["batch"])
        self.ivf = ({k: route[k] for k in ("num_clusters", "n_probe", "kmeans_iters")}
                    if route["retriever"] == "ivf_pallas" else None)
        # the catalog, its contexts and the index come from the traffic's
        # data_seed where it names one, so that every run seed meets the
        # same lists; elsewhere from the run's seed
        data = t.get("data_seed", seed)
        self.index_seed = gen.sub_seed(data, INDEX_STREAM) % INT32_MAX
        self._ref_index: dict = {}
        self.steps_per_call = t["steps_per_call"]
        self.trace_seconds = t["trace_seconds"]
        self.ref_steps, self.window_steps = t["reference_steps"], t["window_reference_steps"]
        if not 0 < self.window_steps < self.steps_per_call:
            raise ValueError("the window's judged steps have to be fewer than a call's")
        g = gen.device_generator(device, seed, DATA_STREAM)
        l = c["embed_dim"]
        self.beta, self.contexts = gen.clustered_catalog(
            c["num_items"], l, t["catalog_clusters"], c["num_users"], std=t["cluster_std"],
            query_blend=t["query_blend"],
            gen=g if data == seed else gen.device_generator(device, data, DATA_STREAM))
        self.w0 = torch.randn((l, l), generator=g, device=device).div_(l ** 0.5)
        self.positives = gen.session_positives(self.contexts @ self.w0, self.beta,
                                               t["positives_from_top"], t["positives"], g)
        self.loader_seed = gen.sub_seed(seed, LOADER_STREAM)
        self.phases("inputs")
        ds = SessionDataset(contexts=self.contexts.cpu().numpy(),
                            positives=self.positives.cpu().numpy(),
                            item_embeddings=self.beta, num_items=c["num_items"])
        retriever_kwargs = {}
        if self.ivf is not None:
            from repro_torch.mips import ivf

            with ivf_ref.deterministic():
                index = ivf.build_ivf(self.beta, self.ivf["num_clusters"],
                                      kmeans_iters=self.ivf["kmeans_iters"],
                                      seed=self.index_seed, device=device)
            retriever_kwargs = {"index": index, "n_probe": self.ivf["n_probe"]}
            self.phases("index")
        fopo = FOPOConfig(num_items=c["num_items"], num_samples=c["num_samples"],
                          top_k=c["top_k"], epsilon=c["epsilon"], retriever=route["retriever"],
                          fused=route["fused"], fused_sampler=route["fused_sampler"],
                          sample_tile=route["sample_tile"])
        cfg = TrainerConfig(estimator="fopo", fopo=fopo, batch_size=t["batch"],
                            learning_rate=c["learning_rate"], num_steps=2**62,
                            seed=self.loader_seed)
        self.trainer = FOPOTrainer(cfg, ds, retriever_kwargs=retriever_kwargs, device=device,
                                   params={"w": self.w0.clone()},
                                   step_seeds=lambda s: step_seed(seed, s))
        self.clock = _Clock(device)
        self.marks: list = []
        self.trainer.loader = _TimedLoader(self.trainer.loader, self.clock, self.marks,
                                           self._on_batch)
        # the plan's retriever, with the top-K it hands the sampler recorded
        # in a call's first steps; set-up and window run this same plan
        plan = self.trainer.plan
        self.trainer.plan = dataclasses.replace(
            plan, retriever=lambda h, beta: self._recorded(plan.retriever(h, beta)))
        self._rec: dict | None = None
        self._steps = 0  # steps run, as the harness counts them
        self.phases("trainer")
        self.program = self._recorded_call(self.ref_steps, self.ref_steps)
        self.phases("first steps")
        self._recorded_call(self.steps_per_call, self.window_steps)  # the window's shapes
        self.phases("warm steps")
        self._losses: list[float] = []
        self._last: dict | None = None

    # -- the record of a call's first steps -----------------------------------
    def _state(self) -> tuple:
        st = self.trainer.opt_state
        return tuple(x.detach().clone() for x in
                     (self.trainer.params["w"], st["m"]["w"], st["v"]["w"]))

    def _on_batch(self) -> None:
        rec = self._rec
        if rec is not None and len(rec["states"]) <= rec["n"]:
            rec["states"].append(self._state())

    def _recorded(self, top):
        rec = self._rec
        if rec is not None and len(rec["topk"]) < rec["n"]:
            rec["topk"].append((top.scores.detach().clone(), top.indices.detach().clone()))
        return top

    def _recorded_call(self, steps: int, n: int) -> dict:
        """One call of ``steps`` steps, with its first ``n`` recorded: the
        step number it started at, the state before and after them, their
        top-K, losses and ESS."""
        self._rec = rec = {"n": n, "states": [], "topk": []}
        first = self._steps
        hist = self.trainer.train(steps)
        self._steps += steps
        self._rec = None
        if len(rec["states"]) <= n:
            rec["states"].append(self._state())
        (w_s, m_s, v_s), (_, m_1, _) = rec["states"][0], rec["states"][1]
        return {"first_step": first, "start": w_s, "moments": (m_s, v_s),
                "params": rec["states"][n][0], "topk": rec["topk"],
                "losses": hist["loss"][:n], "ess": hist["ess"][:n], "all_losses": hist["loss"],
                "grad1": (m_1 - ref.ADAM_B1 * m_s) / (1.0 - ref.ADAM_B1)}

    # -- the window ------------------------------------------------------------
    def run_unit(self) -> None:
        with bench_span("train"):
            self._last = self._recorded_call(self.steps_per_call, self.window_steps)
        self._losses += self._last["all_losses"]

    def window_begin(self) -> None:
        self._first = len(self.marks)
        self._losses = []

    def window_end(self) -> dict:
        self.marks.append(self.clock.mark())
        if self.clock.cuda:
            torch.cuda.synchronize(self.device)
        ms = [self.clock.ms(a, b) for a, b in zip(self.marks[self._first:-1],
                                                   self.marks[self._first + 1:])]
        self.marks.clear()
        return {"step_ms": ms, "steps": len(ms),
                "nonfinite": int(sum(not np.isfinite(x) for x in self._losses)),
                "notes": {"step_ms_p50": percentile(ms, 50) if ms else None}}

    def end_to_end(self, win: dict) -> dict:
        return {"train_contexts_per_s": win["steps"] * self.shape.batch / win["elapsed_s"],
                "train_step_ms_p95": percentile(win["step_ms"], 95)}

    def attempted_failed(self, win: dict) -> tuple[int, int]:
        return win["steps"], win["nonfinite"]

    def counters(self, win: dict) -> dict:
        s = self.shape
        return {"steps": win["steps"], "batch": s.batch, "num_items": s.num_items,
                "embed_dim": s.embed_dim, "num_samples": s.num_samples, "top_k": s.top_k,
                "n_probe": self.ivf["n_probe"] if self.ivf is not None else None,
                "num_clusters": self.ivf["num_clusters"] if self.ivf is not None else None,
                "step_flops": work.fopo_step_flops(s.batch, s.num_items, s.embed_dim,
                                                   s.num_samples)}

    # -- the judge ---------------------------------------------------------------
    def release(self) -> None:
        self.trainer = None
        if self.clock.cuda:
            torch.cuda.empty_cache()

    def segments(self) -> list[dict]:
        """The recorded runs of steps the judge follows: the set-up's from
        theta0, then the first steps of the window's last call."""
        return [self.program] + ([self._last] if self._last is not None else [])

    def _retrieve(self, precision: str, index_seed: int):
        """The reference's retrieval h -> (scores, ids) on this route: None
        (the exact top-K) or the probe of its own IVF index, built once
        for each precision and seed."""
        if self.ivf is None:
            return None
        key = (precision, index_seed)
        if key not in self._ref_index:
            with ivf_ref.deterministic():
                self._ref_index[key] = ivf_ref.build_index(
                    self.beta, self.ivf["num_clusters"], index_seed, precision,
                    iters=self.ivf["kmeans_iters"])
        cents, lists = self._ref_index[key]
        k, n_probe = self.shape.top_k, self.ivf["n_probe"]
        return lambda h: ivf_ref.answers(h, cents, lists, self.beta, k, n_probe, precision)

    def reference(self, seg: dict, precision: str = "fp32", follow: bool = True,
                  index_seed: int | None = None, **fault) -> dict:
        """The reference over ``seg``'s steps from the state they started
        from, drawing from their recorded top-K where ``follow``; on the
        IVF route its index is built with ``index_seed`` (default: the
        program's)."""
        # the set-up's steps start from the benchmark's own theta0
        start = None if seg["first_step"] == 0 else (seg["start"], *seg["moments"])
        retrieve = self._retrieve(precision, self.index_seed if index_seed is None else index_seed)
        return ref.reference_run(self.contexts, self.positives, self.beta, self.w0,
                                 lambda s: step_seed(self.seed, s), self.loader_seed,
                                 self.shape, steps=len(seg["losses"]), precision=precision,
                                 follow=seg["topk"] if follow else None, start=start,
                                 first_step=seg["first_step"], retrieve=retrieve, **fault)

    def _numbers(self, as_program) -> dict:
        """The numbers with ``as_program(seg)`` in the program's place: the
        fp32 reference follows the top-K of what stands there."""
        try:
            pairs = []
            for seg in self.segments():
                prog = as_program(seg)
                pairs.append((prog, self.reference(dict(seg, topk=prog["topk"]))))
        except ref.FollowMismatch:  # a retrieval that missed rows of its batch
            return dict.fromkeys(compare.TRAINING_NUMBERS, math.inf)
        return compare.training_numbers(pairs, self.beta)

    def judge(self) -> dict:
        self.release()
        with torch.no_grad():
            return self._numbers(lambda seg: seg)

    def calibration(self, control: bool, seconds: float) -> dict:
        """The readings the limits are set from: the program's numbers after
        a window of ``seconds``; with ``control`` also the control's (the
        reference in TF32 in the program's place) and those of faults
        planted in the reference put there: a step that returns its state
        unchanged; half of the batch left out with the mean taken over
        the rest (its top-K covers half the rows, so it is held to the
        reference drawing from its own); a stale top-K (each step draws
        from its run's first top-K); and on the IVF route a top-K from
        an index built with another seed."""
        run_window(self, seconds)
        line = {"program": self.judge()}
        if control:
            with torch.no_grad():
                line["control"] = self._numbers(
                    lambda seg: self.reference(seg, "tf32", follow=False))
                line["state_unchanged"] = self._numbers(
                    lambda seg: self.reference(seg, follow=False, frozen=True))
                line["half_batch"] = compare.training_numbers(
                    [(self.reference(seg, follow=False, keep_rows=0.5),
                      self.reference(seg, follow=False)) for seg in self.segments()], self.beta)
                line["stale_topk"] = self._numbers(
                    lambda seg: self.reference(dict(seg, topk=seg["topk"][:1] * len(seg["topk"]))))
                if self.ivf is not None:
                    other = gen.sub_seed(self.index_seed, INDEX_STREAM) % INT32_MAX
                    line["other_index"] = self._numbers(
                        lambda seg: self.reference(seg, follow=False, index_seed=other))
        return line
