"""Serving launcher of the port: the continuous-batching engine over the
SASRec or DIEN retrieval route (through the `ivf_topk` CUDA kernel), the
DIN or Wide&Deep dense-candidate route (each request scores a fixed pool
of 500 candidates, `np.arange(500)`) or the LM generation route (any LM
arch: gemma2-2b, olmoe-1b-7b, arctic-480b, granite-8b, mistral-large-123b)
(prefill, then greedy decoding with every next token through the same
`ivf_topk` plan path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch din --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dien --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --device cpu \
        --requests 24 --ladder
    PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --device cpu \
        --requests 24 --replicas 3 --chaos --obs-dir /tmp/serve_run

Requests are enqueued on a virtual arrival clock (``--qps`` spaces them;
0 = all at once, the closed-loop shape) and coalesced into padded
micro-batches under ``--max-batch`` / ``--max-wait-ms``. The model is
the arch's SMOKE_CONFIG with random weights from a fixed seed, and the
payloads are the reference CLI's: a history of ids in [-1, item_vocab)
(sasrec, dien, din), 40 sparse ids in [0, 10^6) and normal dense
features (wide-deep), or a random prompt of ``--prompt-len`` tokens
answered with ``--gen-len`` generated ones (the LM arches). The run needs
CUDA unless ``--device cpu`` is given. ``--ladder`` arms the retrieval
degradation ladder on the live index of the MIPS arches (sasrec, dien):
32 held probe histories, a recall probe every 4 batches, floor 0.5.

Serving rides the telemetry spine (repro_torch.obs): per-request queue
wait and latency timings, per-batch service spans and occupancy gauges.
``--obs-dir DIR`` leaves metrics.jsonl and trace.json behind for
``python -m repro_torch.obs.report DIR`` (which renders a Serving
section, and a Cluster section for a cluster run).

``--replicas N`` (N > 1) serves the same stream through the cluster
dispatcher instead (repro_torch.serve.cluster): N route replicas, each
building its own index, behind least-loaded routing, health checks and
bounded retry. ``--chaos`` scripts a replica death (replica 1 dies at its
first dispatch and is marked dead at its first failure); the run must
still answer every request by re-queuing onto the survivors, and exits
non-zero if it does not. graphcast (the GNN, not ported yet) is refused
with a message naming its slice (ROADMAP Queue A item 6, models).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.health.faults import ReplicaFaultPlan
from repro_torch.health.index_health import IndexHealthConfig
from repro_torch.models import lm, recsys
from repro_torch.obs.report import percentile
from repro_torch.obs.run import ObsConfig, ObsRun
from repro_torch.serve import (
    CoalescePolicy,
    DenseCandidateRoute,
    Dispatcher,
    DispatchPolicy,
    LMGenerateRoute,
    RecsysMIPSRoute,
    ServingEngine,
)


def build_route(mod, args, rng, device):
    """The arch's serving route on ``device`` and a payload generator;
    the weights come from seed 0 on every call."""
    cfg = mod.SMOKE_CONFIG
    gen = torch.Generator(device=device).manual_seed(0)
    if mod.FAMILY == "lm":
        params = lm.init_params(cfg, gen, device)
        route = LMGenerateRoute(
            cfg, params, prompt_len=args.prompt_len, gen_len=args.gen_len,
            max_batch=args.max_batch, device=device,
        )

        def payload():
            return rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
        return cfg, route, payload
    if mod.FAMILY != "recsys":
        raise SystemExit(f"{cfg.name} ({mod.FAMILY}) has no serving path")
    params = recsys.init_params(cfg, gen, device)
    if cfg.kind in ("sasrec", "dien"):
        probe = None
        if args.ladder:
            probe = rng.integers(-1, cfg.item_vocab, (32, cfg.seq_len)).astype(np.int32)
        route = RecsysMIPSRoute(cfg, params, k=args.k, probe_hists=probe, device=device)
    else:
        route = DenseCandidateRoute(
            cfg, params, candidates=np.arange(500, dtype=np.int32), k=args.k,
            device=device,
        )
    if cfg.kind == "wide_deep":
        def payload():
            return (rng.integers(0, 10**6, (cfg.n_sparse,)).astype(np.int32),
                    rng.normal(size=(cfg.n_dense,)).astype(np.float32))
    else:
        def payload():
            return rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
    return cfg, route, payload


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered arrival rate (0 = all at t=0, closed loop)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=10, help="top-k per request")
    ap.add_argument("--prompt-len", type=int, default=16, help="LM prompt tokens")
    ap.add_argument("--gen-len", type=int, default=8, help="LM generated tokens")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ladder", action="store_true",
                    help="arm the retrieval degradation ladder (MIPS archs)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through the cluster dispatcher with N replicas "
                         "(1 = single engine)")
    ap.add_argument("--chaos", action="store_true",
                    help="script a replica death mid-traffic (needs --replicas >= 2)")
    ap.add_argument("--obs-dir", default=None,
                    help="write metrics.jsonl + trace.json here")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.chaos and args.replicas < 2:
        raise SystemExit("--chaos needs --replicas >= 2 (survivors must exist)")
    try:
        mod = get_arch(args.arch)
    except NotImplementedError as exc:
        raise SystemExit(str(exc)) from None
    if mod.FAMILY not in ("lm", "recsys"):
        raise SystemExit(f"{mod.SMOKE_CONFIG.name} ({mod.FAMILY}) has no serving path")
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    obs_cfg = ObsConfig(run_dir=args.obs_dir, drift=None) if args.obs_dir else None
    with ObsRun(obs_cfg) as run:
        cfg, route, payload = build_route(mod, args, rng, device)
        health = None
        if args.ladder and hasattr(route, "probe"):
            health = IndexHealthConfig(probe_every=4, recall_floor=0.5)
        coalesce = CoalescePolicy(
            max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3
        )
        if args.replicas > 1:
            _serve_cluster(args, mod, cfg, route, payload, coalesce, health, run, rng,
                           device)
        else:
            _serve_one(args, cfg, route, payload, coalesce, health, run, device)
    if args.obs_dir:
        print(f"obs artifacts in {args.obs_dir}")


def _serve_one(args, cfg, route, payload, coalesce, health, run, device) -> None:
    """One engine over one route."""
    bus = run.bus
    engine = ServingEngine(route, coalesce, bus=bus, health=health)
    engine.warmup()
    for i in range(args.requests):
        engine.submit(payload(), arrival=i / args.qps if args.qps else 0.0)
    records = engine.drain()
    lats = engine.latencies()
    makespan = max(r.finish for r in records) - records[0].arrival
    bus.log(
        f"{cfg.name} on {device}: {len(records)} requests in {engine.batches} "
        f"batches (occupancy {engine.occupancy():.2f}) — p50 "
        f"{percentile(lats, 50) * 1e3:.1f} ms, p99 "
        f"{percentile(lats, 99) * 1e3:.1f} ms, "
        f"{len(records) / makespan:.1f} req/s"
    )
    if engine.monitor is not None:
        probes = [h for h in engine.monitor.history if h["recall"] is not None]
        actions = [h["action"] for h in engine.monitor.history if h["action"]]
        recalls = ", ".join(f"{h['recall']:.3f}" for h in probes) or "none"
        bus.log(
            f"ladder: {len(probes)} recall probes ({recalls}); actions "
            f"{actions or 'none'}; degraded: {engine.route.degraded}"
        )
    bus.drain()


def _serve_cluster(args, mod, cfg, first_route, payload, coalesce, health, run, rng,
                   device) -> None:
    """The --replicas > 1 path: N route copies behind the dispatcher."""
    routes = [first_route]
    for _ in range(args.replicas - 1):
        _, route, _ = build_route(mod, args, rng, device)
        routes.append(route)
    # kill replica 1 at its FIRST dispatch (least-loaded routing gives it
    # one; measured service times make later dispatch counts vary from
    # run to run) and mark it dead at its first failure: the CLI drill is
    # a demonstration, not a flap-tolerance test
    plan = ReplicaFaultPlan(die=((1, 1),)) if args.chaos else None
    policy = DispatchPolicy(max_failures=1) if args.chaos else DispatchPolicy()
    disp = Dispatcher(
        routes, coalesce, policy, bus=run.bus, health=health, fault_plan=plan,
    )
    disp.warmup()
    for i in range(args.requests):
        disp.submit(payload(), arrival=i / args.qps if args.qps else 0.0)
    res = disp.drain()
    lats = disp.latencies()
    split = ", ".join(
        f"r{r['replica']}:{r['requests']}{'' if r['alive'] else ' (dead)'}"
        for r in disp.per_replica()
    )
    run.bus.log(
        f"{cfg.name} on {device} x{args.replicas} replicas"
        f"{' [chaos: kill replica 1]' if args.chaos else ''}: "
        f"{len(res)} answered / {len(res.unanswered)} unanswered — p50 "
        f"{percentile(lats, 50) * 1e3:.1f} ms, p99 "
        f"{percentile(lats, 99) * 1e3:.1f} ms; retries "
        f"{disp.bus.total('serve_retries'):g}, deaths "
        f"{disp.bus.total('serve_replica_deaths'):g}, rebalances "
        f"{disp.bus.total('serve_rebalances'):g}; load [{split}]"
    )
    run.bus.drain()
    if args.chaos and res.unanswered:
        raise SystemExit(
            f"chaos run dropped {len(res.unanswered)} requests: the re-queue "
            "path must answer everything with survivors up"
        )


if __name__ == "__main__":
    main()
