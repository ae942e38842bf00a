"""Bulk retrieval through the program's serving route, `repro_torch
.serve.RecsysMIPSRoute`, as a job that refreshes every user's candidates
would call it: the histories of a queue of users in one host array
(pinned), cycled through in batches, each batch handed to the route's
batched entry (`run`: the tower, the centroid stage and K7) and its
answers copied back into a host array. The route's per-request glue
(`prepare` stacks one array a user, `finalize` splits the answers into
one tuple a user) is the serving engine's, which a bulk job leaves out.

Batches are dispatched ahead on the device's stream, up to ``ahead`` of
them in flight (CUDA's launch queue may hold fewer: the host then
waits in a launch), so the device stays fed while the host stands still;
the job hands a batch's answers back once its copy has landed, and
waits for the oldest only when ``ahead`` are in flight. The window ends
as the harness ends it: nothing more is sent, every batch in flight is
waited for and handed back, and only then is the clock read.

The work is the same for every seed: the weights, the item table and
the queue's histories come from the traffic's fixed ``data_seed``, and
the run's seed orders the queue (a permutation of its users) and picks
the batches the judge holds to the reference. Each run cycles through
the whole queue many times, so every seed retrieves for the same users
against the same index, in another order.

Set-up makes the weights and the histories on the device, builds the
route (its IVF index under torch's deterministic algorithms,
so that the index is a function of ``data_seed``, as the reference's is) and
warms it on the queue's first batches. The window keeps the answers of
the batches that the seed picks; the judge frees the route and holds
those answers to `bench.reference.sasrec`.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from bench.harness import PhaseClock, bench_span, run_window
from bench.reference import compare
from bench.reference import sasrec as ref
from bench.reference.precision import fp32_products
from bench.yardstick import gen, work

__all__ = ["Run"]

DATA_STREAM, HIST_STREAM, INDEX_STREAM, JUDGE_STREAM, ORDER_STREAM = 1, 2, 3, 4, 5


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.configs.sasrec import CONFIG
        from repro_torch.serve import RecsysMIPSRoute

        fp32_products()
        self.phases = PhaseClock(device)
        self.device, self.seed, self.config = device, seed, config
        c, t = config, traffic
        self.batch, self.k, self.n_probe = t["batch"], c["top_k"], c["n_probe"]
        self.trace_seconds = t["trace_seconds"]
        self.judge_every, self.judge_batches = t["judge_every"], t["judge_batches"]
        if t["users"] % self.batch:
            raise ValueError(f"{t['users']} users do not fill batches of {self.batch}")
        data = t["data_seed"]
        self.params = gen.sasrec_params(c["item_vocab"], c["embed_dim"], c["seq_len"],
                                        c["num_blocks"], gen.device_generator(device, data,
                                                                              DATA_STREAM))
        hists = gen.zipf_histories(t["users"], c["seq_len"], c["item_vocab"], t["zipf_a"],
                                   gen.device_generator(device, data, HIST_STREAM))
        order = gen.device_generator(device, seed, ORDER_STREAM)
        hists = hists[torch.randperm(t["users"], generator=order, device=device)]
        cuda = device.type == "cuda"
        self.queue = hists.cpu().pin_memory() if cuda else hists.cpu()  # the job's input
        del hists
        # the answers' landing slots on the host, one a batch in flight
        self.ahead = t["ahead"]
        shape = (self.ahead, self.batch, self.k)
        self.ids_host = torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
        self.scores_host = torch.empty(shape, dtype=torch.float32, pin_memory=cuda)
        self.index_seed = gen.sub_seed(data, INDEX_STREAM) % (2**31 - 1)
        self.phases("inputs")
        cfg = dataclasses.replace(CONFIG, **{
            k: c[k] for k in ("item_vocab", "embed_dim", "seq_len", "num_blocks", "num_heads")})
        with ref.deterministic():
            self.route = RecsysMIPSRoute(cfg, self.params, k=self.k,
                                         num_clusters=c["num_clusters"], n_probe=self.n_probe,
                                         seed=self.index_seed, device=device)
        self.phases("route and index")
        self.in_flight: collections.deque = collections.deque()  # (batch, slot, event, rows)
        self.next = 0  # the queue's next batch
        self.kept: list[tuple[int, tuple]] = []  # (batch number, answers) for the judge
        self.window_begin()
        for _ in range(t["warm_batches"]):  # the queue's first batches; the window goes on
            self.run_unit()
        self.window_end()
        self.kept = []
        self.phases("warm batches")

    # -- the window ------------------------------------------------------------
    def _rows(self, i: int) -> slice:
        lo = (i * self.batch) % self.queue.shape[0]
        return slice(lo, lo + self.batch)

    def run_unit(self) -> None:
        """Send the queue's next batch to the device and dispatch its
        retrieval and the copy of its answers back, waiting only when
        ``ahead`` batches are in flight; hand back every batch whose
        answers have landed."""
        if len(self.in_flight) >= self.ahead:
            self._hand_back()
        i = self.next
        slot = i % self.ahead
        with bench_span("send"):
            x = self.queue[self._rows(i)].to(self.device, non_blocking=True)
        with bench_span("run"):
            out = self.route.run(x)
        with bench_span("copy_back"):
            rows = out.indices.shape[0]
            self.ids_host[slot, :rows].copy_(out.indices, non_blocking=True)
            self.scores_host[slot, :rows].copy_(out.scores, non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        self.in_flight.append((i, slot, event, rows))
        self._deepest = max(self._deepest, len(self.in_flight))
        self.next = i + 1
        while self.in_flight and (self.in_flight[0][2] is None or self.in_flight[0][2].query()):
            self._hand_back()

    def _hand_back(self) -> None:
        """Wait for the oldest batch in flight and hand its answers back:
        count the users it answered, keep them for the judge if the seed
        picks the batch."""
        i, slot, event, rows = self.in_flight.popleft()
        if event is not None:
            with bench_span("wait"):
                event.synchronize()
        self._failed += self.batch - rows
        if gen.sub_seed(self.seed, 100_000 + i) % self.judge_every == 0:
            self.kept.append((i, self._answers(slot, rows)))
        self._last = (i, slot, rows)
        self._batches.append(i)

    def _answers(self, slot: int, rows: int) -> tuple:
        """A copy of a slot's answers: (ids [rows, K], scores [rows, K])."""
        return (self.ids_host[slot, :rows].numpy().copy(),
                self.scores_host[slot, :rows].numpy().copy())

    def window_begin(self) -> None:
        self._batches: list[int] = []
        self._failed = 0
        self._deepest = 0

    def window_end(self) -> dict:
        """Hand back every batch still in flight; the window's batches are
        those handed back in it."""
        while self.in_flight:
            self._hand_back()
        return {"batches": list(self._batches), "failed": self._failed,
                "notes": {"index_lists": list(self.route.planner.index_state.lists.shape),
                          "ahead": self.ahead, "deepest": self._deepest}}

    def end_to_end(self, win: dict) -> dict:
        users = len(win["batches"]) * self.batch - win["failed"]
        return {"retrieval_users_per_s": users / win["elapsed_s"]}

    def attempted_failed(self, win: dict) -> tuple[int, int]:
        return len(win["batches"]) * self.batch, win["failed"]

    def counters(self, win: dict) -> dict:
        """The work of the traced batches: their probed lists' live rows,
        from the route's index and queries recomputed outside the window."""
        planner = self.route.planner
        state = planner.index_state
        live = (state.lists >= 0).sum(dim=1).to(torch.float64)
        c = self.config
        union, probed = [], []
        with torch.inference_mode():
            for i in win["batches"]:
                x = self.queue[self._rows(i)].to(self.device)
                h = planner.policy.user_embedding(planner.params, x)
                probe = torch.topk(h @ state.centroids.T, self.n_probe, dim=1).indices
                union.append(float(live[torch.unique(probe)].sum()))
                probed.append(float(live[probe].sum()))
        b = self.batch
        return {
            "batches": len(win["batches"]), "batch": b, "embed_dim": c["embed_dim"],
            "top_k": self.k, "n_probe": self.n_probe, "union_live": union,
            "probed_live": probed,
            "tower_flops": work.sasrec_tower_flops(b, c["seq_len"], c["embed_dim"],
                                                   c["num_blocks"]),
            "centroid_flops": work.centroid_stage_flops(b, c["num_clusters"], c["embed_dim"]),
        }

    # -- the judge ---------------------------------------------------------------
    def release(self) -> None:
        self.route = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged(self) -> list[tuple[int, tuple]]:
        """The kept batches the seed picks for the judge, or the window's
        last batch when none was kept."""
        if not self.kept:
            i, slot, rows = self._last
            self.kept = [(i, self._answers(slot, rows))]
        kept = self.kept
        rng = np.random.default_rng(gen.sub_seed(self.seed, JUDGE_STREAM))
        pick = sorted(rng.choice(len(kept), min(len(kept), self.judge_batches), replace=False))
        return [kept[j] for j in pick]

    def reference(self, precision: str = "fp32"):
        """The reference's index, then for each judged batch its queries
        and answers: [(batch number, u, scores, ids)]."""
        c = self.config
        items = self.params["items"]
        with ref.deterministic():
            cents, lists = ref.build_index(items, c["num_clusters"], self.index_seed, precision,
                                           iters=c["kmeans_iters"])
        out = []
        for i, _ in self.judged():
            hist = self.queue[self._rows(i)].to(self.device)
            u = ref.user_vectors(self.params, hist, c["num_heads"], precision)
            scores, ids = ref.answers(u, cents, lists, items, self.k, self.n_probe, precision)
            out.append((i, u, scores, ids))
        return out

    def numbers(self, answers_of: dict, ref_out: list) -> dict:
        """The judge's numbers of the answers in ``answers_of`` (batch number
        -> (ids [rows, K], scores [rows, K])) against the reference's."""
        items = self.params["items"]
        ids, scores, answered, us, r_ids, r_scores = [], [], [], [], [], []
        for i, u, rs, ri in ref_out:
            a_ids, a_sc = answers_of[i]
            n, rows = self.batch, min(a_ids.shape[0], self.batch)
            pid = np.full((n, self.k), -1, np.int64)
            psc = np.zeros((n, self.k), np.float32)
            pid[:rows, :a_ids.shape[1]] = a_ids[:rows, :self.k]
            psc[:rows, :a_sc.shape[1]] = a_sc[:rows, :self.k]
            ids.append(torch.from_numpy(pid))
            scores.append(torch.from_numpy(psc))
            answered.append(torch.arange(n) < rows)
            us.append(u)
            r_ids.append(ri)
            r_scores.append(rs)
        dev = items.device
        return compare.retrieval_numbers(
            torch.cat(ids).to(dev), torch.cat(scores).to(dev), torch.cat(answered).to(dev),
            torch.cat(us), items, torch.cat(r_ids), torch.cat(r_scores))

    def judge(self) -> dict:
        answers_of = dict(self.judged())
        self.release()
        with torch.no_grad():
            return self.numbers(answers_of, self.reference())

    def calibration(self, control: bool, seconds: float) -> dict:
        """The readings the limits are set from: the program's numbers
        after a window of ``seconds`` at the cell's load; with ``control``
        also the control's, the reference in TF32 in the program's place."""
        run_window(self, seconds)
        answers_of = dict(self.judged())
        self.release()
        with torch.no_grad():
            reference = self.reference()
            line = {"program": self.numbers(answers_of, reference)}
            if control:
                line["control"] = self.numbers(_as_answers(self.reference("tf32")), reference)
        return line


def _as_answers(ref_out: list) -> dict:
    """A reference's answers in the job's form: batch -> (ids, scores)."""
    return {i: (ids.cpu().numpy(), scores.cpu().numpy()) for i, _, scores, ids in ref_out}
