"""Serving launcher of the port: the continuous-batching engine over the
SASRec or DIEN retrieval route (through the `ivf_topk` CUDA kernel), the
DIN or Wide&Deep dense-candidate route (each request scores a fixed pool
of 500 candidates, `np.arange(500)`) or the Gemma-2 generation route
(prefill, then greedy decoding with every next token through the same
`ivf_topk` plan path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch din --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dien --device cpu

Requests are enqueued on a virtual arrival clock (``--qps`` spaces them;
0 = all at once, the closed-loop shape) and coalesced into padded
micro-batches under ``--max-batch`` / ``--max-wait-ms``. The model is
the arch's SMOKE_CONFIG with random weights from a fixed seed, and the
payloads are the reference CLI's: a history of ids in [-1, item_vocab)
(sasrec, dien, din), 40 sparse ids in [0, 10^6) and normal dense
features (wide-deep), or a random prompt of ``--prompt-len`` tokens
answered with ``--gen-len`` generated ones (gemma2-2b). The run needs
CUDA unless ``--device cpu`` is given.

Not ported yet, and refused with a message naming the slice (ROADMAP
Queue A item): ``--ladder`` (health, item 6), ``--replicas`` /
``--chaos`` (cluster serving, item 8) and ``--obs-dir`` (observability,
item 7), and the arches that are not ported (models, item 10).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import lm, recsys
from repro_torch.obs.bus import MetricsBus
from repro_torch.obs.sinks import HumanLogSink
from repro_torch.serve import (
    CoalescePolicy,
    DenseCandidateRoute,
    LMGenerateRoute,
    RecsysMIPSRoute,
    ServingEngine,
)

_NOT_PORTED = {
    "ladder": "the health slice (ROADMAP Queue A item 6)",
    "replicas": "the cluster slice (ROADMAP Queue A item 8)",
    "chaos": "the cluster slice (ROADMAP Queue A item 8)",
    "obs_dir": "the observability slice (ROADMAP Queue A item 7)",
}


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile."""
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, round(p / 100.0 * (len(vs) - 1))))]


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
    ap.add_argument("--ladder", action="store_true", help="not ported yet")
    ap.add_argument("--replicas", type=int, default=1, help="not ported yet")
    ap.add_argument("--chaos", action="store_true", help="not ported yet")
    ap.add_argument("--obs-dir", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for opt, slice_name in _NOT_PORTED.items():
        if getattr(args, opt) != ap.get_default(opt):
            flag = "--" + opt.replace("_", "-")
            raise SystemExit(
                f"{flag} is not ported to repro_torch yet; it comes with "
                f"{slice_name}"
            )
    try:
        mod = get_arch(args.arch)
    except NotImplementedError as exc:
        raise SystemExit(str(exc)) from None
    cfg = mod.SMOKE_CONFIG
    if mod.FAMILY not in ("lm", "recsys"):
        raise SystemExit(f"{cfg.name} ({mod.FAMILY}) has no serving path")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)
    if mod.FAMILY == "lm":
        params = lm.init_params(cfg, gen, device)
        route = LMGenerateRoute(
            cfg, params, prompt_len=args.prompt_len, gen_len=args.gen_len,
            max_batch=args.max_batch, device=device,
        )

        def payload():
            return rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
    else:
        params = recsys.init_params(cfg, gen, device)
        if cfg.kind in ("sasrec", "dien"):
            route = RecsysMIPSRoute(cfg, params, k=args.k, device=device)
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
    bus = MetricsBus(sinks=[HumanLogSink()])
    engine = ServingEngine(
        route,
        CoalescePolicy(max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3),
        bus=bus,
    )
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
    bus.close()


if __name__ == "__main__":
    main()
