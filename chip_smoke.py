#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and no network,
and imports neither JAX nor the reference package. Phases, one line or
more each:

  1. environment  torch and CUDA versions, the card's name and power limit
  2. build        every hand-written kernel, from source (one nvcc per
                  source, all started together), timed
  3. kernels      each kernel against its plain PyTorch version on the
                  card, at small shapes and at the shapes its path gives
                  it, within the CPU parity tests' tolerances; times of
                  the kernel and the plain version (device time per call
                  from a replayed CUDA graph, and time per eager call),
                  the library call where one computes the same function,
                  and the least time the card could take for the same
                  work (bytes over 3.35 TB/s or operations over 67
                  TFLOP/s fp32, the larger)
  4. serve        the serving path at full SASRec width (10^6 items,
                  embed 50, 2 blocks, 1 head, seq 50; random weights from
                  a seed): `RecsysMIPSRoute` builds its IVF index, then a
                  `ServingEngine` with max_batch=8 answers 64 requests;
                  the launch counters show the path went through the
                  kernel, and the answers are held to the plain path on
                  the CPU; then one pass over the same batches split into
                  stages (prepare, tower, retrieval, finalize)
  5. train        `FOPOTrainer` trains fopo-paper at full width (P 750,000,
                  L 100, S 1000, K 256, eps 0.8, batch 32, lr 1e-4)
                  through the kernel path (retriever="pallas", fused=True,
                  fused_sampler=True, TS 8) for 20 steps; the launch
                  counters show one launch of each training kernel per
                  step and no plain-version call; step time p50 / p99;
                  a profiled window splits a step's device time by
                  kernel. Then the first 3 steps again on the CPU through
                  the plain versions, from the same theta, Adam state and
                  seeds: the CPU's top-K held to the card's at every step,
                  then the step run on the card's draws and its loss,
                  diagnostics and theta held to the card's. The dataset is
                  cut: beta and
                  the contexts come from the seeded `clustered_catalog`
                  (1024 clusters, 4096 contexts), the positives are 8 ids
                  per context drawn from its exact top-64 under the
                  initial tower (`generate_sessions` cannot make a
                  750,000-item catalog in a smoke run)
  6. a JSON line of the kernels, then the card's name and power limit,
     then the last line {"ok": true, "device": {...}}

Any failed check raises, and the script exits non-zero without the last
line; it also exits non-zero when CUDA is not available.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6  # the CPU parity tests' score tolerances
N_PROBE, K_SERVE, MAX_BATCH, REQUESTS = 8, 10, 8, 64
TRAIN_STEPS, REPLAY_STEPS, PROFILED_STEPS, TS = 20, 3, 3, 8


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets: list, iters: int) -> float:
    """Mean ms per call, launched eagerly from Python: what a caller pays
    per call, host work included. CUDA events around `iters` calls
    cycling through `arg_sets` (distinct inputs, so the 50 MB L2 does
    not hold every call's lists), after one warm-up call of each set."""
    import torch

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets: list, calls: int = 24, replays: int = 10) -> float:
    """Mean device ms per call: `calls` calls captured in one CUDA graph
    and replayed, so no host work sits between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------------------
# ivf_topk: kernel vs plain version
# ---------------------------------------------------------------------------

def topk_err(out, ref, tag: str) -> float:
    """Scores (both sorted descending) within RTOL/ATOL elementwise; ids
    equal as sets per row, except ids whose scores tie the K-th within
    the tolerance (a tie at the boundary may be broken either way).
    Returns the largest absolute score difference."""
    import torch

    (ks, ki), (rs, ri) = out, ref
    torch.cuda.synchronize()
    ks, ki, rs, ri = ks.cpu(), ki.cpu(), rs.cpu(), ri.cpu()
    check(ks.shape == rs.shape and ki.dtype == torch.int32, f"{tag}: shape/dtype")
    check(bool(torch.isfinite(ks).all()), f"{tag}: non-finite kernel scores")
    close = (ks - rs).abs() <= ATOL + RTOL * rs.abs()
    check(bool(close.all()), f"{tag}: scores differ, max {float((ks - rs).abs().max())}")
    check(bool((ks[:, :-1] >= ks[:, 1:]).all()), f"{tag}: scores not descending")
    for row in range(ks.shape[0]):
        a, b = set(ki[row].tolist()), set(ri[row].tolist())
        if a == b:
            continue
        kth = float(rs[row, -1])
        tol = ATOL + RTOL * abs(kth)
        for ids, scores, only in ((ki, ks, a - b), (ri, rs, b - a)):
            for i in only:
                pos = ids[row].tolist().index(i)
                check(abs(float(scores[row, pos]) - kth) <= tol,
                      f"{tag}: row {row} id {i} differs (not a boundary tie)")
    dead = ki < 0
    check(bool((ks[dead] == -3.0e38).all()), f"{tag}: a dead slot is not -3e38")
    return float((ks - rs).abs().max())


def roof(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time for `nbytes` moved and `nops` fp32 operations:
    (ms, "bytes" or "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_FLOPS * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def bound_ms(q, probe, lists, list_embs, k) -> tuple[float, str, float]:
    """The least time for this call's work, from its data: each probed
    list's ids and its live slots' embeddings read once, the queries and
    probe ids read, the outputs written; 2L flops per live candidate.
    Returns (ms, "bytes" or "operations", bytes)."""
    b, l = q.shape
    live = (lists >= 0).sum(dim=1)  # [C]
    per_row_live = live[probe.long()].sum(dim=1)  # [B]
    n_live = float(per_row_live.sum())
    nbytes = (
        b * probe.shape[1] * lists.shape[1] * 4  # list ids
        + n_live * 4 * l  # live embeddings
        + q.numel() * 4 + probe.numel() * 4 + b * k * 8
    )
    return (*roof(nbytes, 2 * l * n_live), nbytes)


def kernel_phase(index, state, users) -> dict:
    """ivf_topk's kernel against its plain version at every listed shape;
    times at the serving shapes. `index`/`state` are the serving route's,
    `users` a list of [8, 50] user vectors from its tower."""
    import torch

    from repro_torch.kernels.ivf_topk import kernel, ref, tile_align_index
    from repro_torch.mips.ivf import build_ivf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0

    def probe_of(q, centroids, n_probe):
        n_probe = min(n_probe, centroids.shape[0])
        return torch.topk(q @ centroids.T, n_probe, dim=1).indices.to(torch.int32)

    def compare(tag, q, probe, lists, embs, k):
        nonlocal max_err
        out = kernel.ivf_probe_topk_cuda(q, probe, lists, embs, k)
        exp = ref.ivf_probe_topk_ref(q, probe, lists, embs, k)
        err = topk_err(out, exp, tag)
        max_err = max(max_err, err)
        log(f"  {tag}: B={q.shape[0]} L={q.shape[1]} C={lists.shape[0]} "
            f"capp={lists.shape[1]} n_probe={probe.shape[1]} K={k} "
            f"max_abs_err={err:.3g} ok")

    # the CPU tests' five parameter sets, on indexes the port builds here
    for p, l, c, b, k, n_probe, cap_tile in [
        (500, 16, 8, 4, 16, 3, 8), (777, 8, 16, 5, 32, 8, 16),
        (256, 32, 4, 3, 8, 2, 128), (300, 16, 8, 4, 16, 5, 7),
        (64, 8, 64, 2, 8, 64, 8),
    ]:
        items = torch.randn((p, l), generator=gen, device=dev)
        q = torch.randn((b, l), generator=gen, device=dev)
        ix = build_ivf(items, num_clusters=c, kmeans_iters=6, device=dev)
        ix, _ = tile_align_index(ix, cap_tile)
        compare(f"small p={p} ct={cap_tile}", q, probe_of(q, ix.centroids, n_probe),
                ix.lists, ix.list_embs, k)

    # ragged list ends (capacity not a multiple of the kernel's 128-slot
    # tile) and K above the candidate count
    for c, capp, l, b, n_probe, k in [(16, 300, 50, 8, 4, 10), (8, 1000, 24, 3, 3, 64),
                                      (8, 16, 8, 3, 1, 96)]:
        lists = torch.randperm(c * capp, generator=gen, device=dev).reshape(c, capp)
        lists = torch.where(torch.rand((c, capp), generator=gen, device=dev) < 0.25,
                            -1, lists).to(torch.int32)
        embs = torch.randn((c, capp, l), generator=gen, device=dev) * (lists >= 0)[..., None]
        q = torch.randn((b, l), generator=gen, device=dev)
        probe = torch.stack([torch.randperm(c, generator=gen, device=dev)[:n_probe]
                             for _ in range(b)]).to(torch.int32)
        compare(f"ragged capp={capp}", q, probe, lists, embs.contiguous(), k)

    # the serving shapes: the full index, K = 10 and 256, and the delta
    # pass, empty (as serving leaves it) and filled
    c = state.lists.shape[0]
    d_lists = (index.num_items + torch.arange(c * 8, device=dev)).reshape(c, 8)
    d_lists = torch.where(torch.rand((c, 8), generator=gen, device=dev) < 0.3, -1,
                          d_lists).to(torch.int32)
    d_embs = (torch.randn((c, 8, users[0].shape[1]), generator=gen, device=dev)
              * (d_lists >= 0)[..., None]).contiguous()
    probes = [probe_of(u, state.centroids, N_PROBE) for u in users]
    timing = {}
    for tag, lists, embs, k in [
        ("main K=10", state.lists, state.list_embs, K_SERVE),
        ("main K=256", state.lists, state.list_embs, 256),
        ("delta empty K=10", state.delta_lists, state.delta_embs, K_SERVE),
        ("delta filled K=10", d_lists, d_embs, K_SERVE),
    ]:
        compare(tag, users[0], probes[0], lists, embs, k)
        sets = [(u, pr, lists, embs, k) for u, pr in zip(users, probes)]
        t_k, t_p = (device_ms(f, sets) for f in (kernel.ivf_probe_topk_cuda,
                                                 ref.ivf_probe_topk_ref))
        e_k, e_p = (time_ms(f, sets, 100) for f in (kernel.ivf_probe_topk_cuda,
                                                    ref.ivf_probe_topk_ref))
        b_ms, b_by, nbytes = bound_ms(users[0], probes[0], lists, embs, k)
        timing[tag] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
        log(f"  time {tag}: device ms per call (CUDA graph) kernel {t_k:.4f}, "
            f"plain {t_p:.4f}; eager ms per call kernel {e_k:.4f}, plain "
            f"{e_p:.4f}; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} MB); "
            f"kernel device time at {100 * b_ms / t_k:.1f}% of the bound")
    return dict(max_abs_err=max_err, timing=timing)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def stage_times(route, payloads, records) -> None:
    """One more pass over the served batches, each stage ended by a
    synchronize: where a batch's service time goes (host and device)."""
    import numpy as np
    import torch

    planner = route.planner
    stages = {"prepare": [], "tower": [], "retrieval": [], "finalize": []}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.inference_mode():
        for i in range(0, len(payloads), MAX_BATCH):
            x = timed("prepare", lambda: route.prepare(payloads[i:i + MAX_BATCH]))
            h = timed("tower", lambda: planner.policy.user_embedding(planner.params, x))
            top = timed("retrieval", lambda: planner.plan.retrieve(
                h, planner.beta, planner.index_state))
            timed("finalize", lambda: route.finalize(top, MAX_BATCH))
    service = sorted({(r.launch, r.finish) for r in records})
    med = {k: float(np.median(v)) for k, v in stages.items()}
    log(f"[serve] batch service (engine) median "
        f"{float(np.median([f - s for s, f in service])) * 1e3:.3f} ms; stages, "
        "median ms over the batches: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f" (sum {sum(med.values()):.3f})")


def timed(tag: str, kernel_fn, plain_fn, sets: list, nbytes: float, nops: float,
          library_fn=None, library_note: str = "") -> dict:
    """Device ms per call (CUDA graph) of the kernel, its plain version and
    the library call; eager ms of the first two; the bound."""
    t_k, t_p = device_ms(kernel_fn, sets), device_ms(plain_fn, sets)
    e_k, e_p = time_ms(kernel_fn, sets, 50), time_ms(plain_fn, sets, 10)
    t_l = device_ms(library_fn, sets) if library_fn is not None else None
    b_ms, b_by = roof(nbytes, nops)
    lib = f"; library {t_l:.4f} ({library_note})" if t_l is not None else ""
    log(f"  time {tag}: device ms per call (CUDA graph) kernel {t_k:.4f}, plain "
        f"{t_p:.4f}{lib}; eager ms per call kernel {e_k:.4f}, plain {e_p:.4f}; bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} MB, {nops / 1e9:.3f} Gop); "
        f"kernel device time at {100 * b_ms / t_k:.1f}% of the bound")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)


def close_err(got, want, tag: str, rtol: float = RTOL, atol: float = ATOL,
              sums: bool = False) -> float:
    """Elementwise |got - want| <= atol + rtol |want|; returns the max
    absolute difference. ``sums=True`` is for outputs that are sums of
    terms of both signs (the scores, L products; g and grad_h, S rows):
    an fp32 sum taken in another order is off by about rtol times the
    size of the terms, not of their sum, so atol becomes
    ATOL + RTOL * max |want| (the output's scale)."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all() == torch.isfinite(want).all()), f"{tag}: non-finite")
    if sums:
        atol = atol + rtol * float(want.abs().max())
    diff = (got - want).abs()
    check(bool((diff <= atol + rtol * want.abs()).all()),
          f"{tag}: differs, max {float(diff.max())}")
    return float(diff.max())


def sampler_err(out, want, tag: str) -> tuple[float, float]:
    """The sampler's kernel against its plain version: the arm choice and
    the uniform-arm draws exactly, the kappa arm at an agreement >= 0.999
    (an fp32 log may flip a near-tie), slot where the draws agree, log q
    within 1e-6 there. Returns (max |log q diff|, kappa agreement)."""
    import torch

    torch.cuda.synchronize()
    (ka, kq, ks), (ra, rq, rs) = ([t.cpu() for t in x] for x in (out, want))
    uniform = rs == -1
    check(bool(torch.equal(ks == -1, uniform)), f"{tag}: arm choice differs")
    check(bool(torch.equal(ka[uniform], ra[uniform])), f"{tag}: uniform-arm draws differ")
    kappa = ~uniform
    agree = float((ka[kappa] == ra[kappa]).float().mean()) if kappa.any() else 1.0
    check(agree >= 0.999, f"{tag}: kappa-arm agreement {agree}")
    same = ka == ra
    check(bool(torch.equal(ks[same], rs[same])), f"{tag}: slots differ")
    err = close_err(kq[same], rq[same], tag + " log q", rtol=1e-6, atol=1e-6)
    return err, agree


def training_data(dev):
    """The full-width fopo-paper dataset, cut as the module docstring says:
    (SessionDataset, theta0 on the CPU, h0 [4096, 100] on the card)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.policy import linear_tower_init
    from repro_torch.data import SessionDataset, clustered_catalog

    cfg = get_arch("fopo-paper").CONFIG
    t0 = time.perf_counter()
    items, contexts = clustered_catalog(cfg.num_items, cfg.embed_dim, num_clusters=1024,
                                        num_queries=4096, seed=0)
    theta0 = linear_tower_init(torch.Generator().manual_seed(0), cfg.embed_dim, cfg.embed_dim)
    beta = torch.from_numpy(items).to(dev)
    h0 = torch.from_numpy(contexts).to(dev) @ theta0["w"].to(dev)
    top64 = torch.cat([torch.topk(h0[i:i + 512] @ beta.T, 64).indices
                       for i in range(0, len(contexts), 512)]).cpu().numpy()
    rng = np.random.default_rng(0)
    pick = np.argsort(rng.random(top64.shape), axis=1)[:, :8]
    positives = np.take_along_axis(top64, pick, axis=1).astype(np.int32)
    ds = SessionDataset(contexts=contexts, positives=positives, item_embeddings=items,
                        num_items=cfg.num_items)
    log(f"[train] dataset: clustered_catalog P={cfg.num_items} L={cfg.embed_dim} (1024 "
        f"clusters), {len(contexts)} contexts, 8 positives each from the exact top-64 "
        f"under theta0; made in {time.perf_counter() - t0:.2f} s")
    return ds, theta0, beta, h0


def training_kernel_phase(beta, h0, positives) -> dict:
    """Each training kernel against its plain version on the card, at
    small shapes and at the training path's shapes (B 32, L 100,
    P 750,000, S 1000, K 256, TS 8; covgrad also at TS 1 and in both
    modes); times at the training shapes."""
    import torch

    from repro_torch.constants import LOG_Q_PAD
    from repro_torch.kernels.fused_sampler import kernel as fk, ref as fr
    from repro_torch.kernels.mips_topk import kernel as mk, ref as mr
    from repro_torch.kernels.snis_covgrad import kernel as sk, ops as so, ref as sr

    dev = beta.device
    gen = torch.Generator(device=dev).manual_seed(2)
    res = {}
    b, l = 32, beta.shape[1]
    p = beta.shape[0]
    k, s = 256, 1000

    # -- mips_topk ----------------------------------------------------------
    err = 0.0
    for bb, pp, ll, kk in [(5, 3000, 24, 64), (3, 700, 17, 10), (40, 5000, 100, 256),
                           (1, 64, 8, 64), (33, 20000, 100, 256)]:
        q = torch.randn((bb, ll), generator=gen, device=dev)
        it = torch.randn((pp, ll), generator=gen, device=dev)
        e = topk_err(mk.mips_topk_cuda(q, it, kk), mr.mips_topk_ref(q, it, kk),
                     f"mips small b={bb} p={pp}")
        err = max(err, e)
        log(f"  mips_topk small: B={bb} P={pp} L={ll} K={kk} max_abs_err={e:.3g} ok")
    hs = [h0[i * b:(i + 1) * b].contiguous() for i in range(4)]
    for i, h in enumerate(hs[:2]):
        e = topk_err(mk.mips_topk_cuda(h, beta, k), mr.mips_topk_ref(h, beta, k),
                     f"mips full {i}")
        err = max(err, e)
        log(f"  mips_topk full: B={b} P={p} L={l} K={k} (training contexts) "
            f"max_abs_err={e:.3g} ok")
    res["mips_topk"] = dict(max_abs_err=err, **timed(
        f"mips_topk B={b} P={p} K={k}", mk.mips_topk_cuda, mr.mips_topk_ref,
        [(h, beta, k) for h in hs], p * l * 4 + b * l * 4 + b * k * 8, 2 * b * p * l,
        library_fn=lambda q, it, kk: torch.topk(q @ it.T, kk),
        library_note="torch.topk(h @ beta.T, K): two calls"))

    # -- fused_sampler --------------------------------------------------------
    err, agree_min = 0.0, 1.0
    for bb, ss, ts, kk, pp, eps, off in [(3, 37, 8, 6, 40, 0.4, 0), (4, 100, 16, 16, 300, 0.8, 3),
                                         (2, 50, 1, 6, 40, 0.25, 5)]:
        sc = 2 * torch.randn((bb, kk), generator=gen, device=dev)
        ids = torch.stack([torch.randperm(pp, generator=gen, device=dev)[:kk]
                           for _ in range(bb)]).int()
        ev = torch.full((), eps, device=dev)
        kw = dict(num_samples=ss, num_items=pp, sample_tile=ts, row_offset=off)
        e, a = sampler_err(fk.fused_sampler_cuda(12345, ev, ids, sc, **kw),
                           fr.fused_sampler_ref(12345, ev, ids, sc, **kw), f"sampler small {ss}")
        err, agree_min = max(err, e), min(agree_min, a)
        log(f"  fused_sampler small: B={bb} S={ss} TS={ts} K={kk} offset={off} "
            f"max_abs_err(log q)={e:.3g} kappa agreement {a:.6f} ok")
    tops = [mk.mips_topk_cuda(h, beta, k) for h in hs]
    eps = torch.full((), 0.8, device=dev)
    kw = dict(num_samples=s, num_items=p, sample_tile=TS)
    for i, (ts_, ti_) in enumerate(tops[:2]):
        e, a = sampler_err(fk.fused_sampler_cuda(1000 + i, eps, ti_, ts_, **kw),
                           fr.fused_sampler_ref(1000 + i, eps, ti_, ts_, **kw), f"sampler full {i}")
        err, agree_min = max(err, e), min(agree_min, a)
        log(f"  fused_sampler full: B={b} S={s} TS={TS} K={k} P={p} (training top-K) "
            f"max_abs_err(log q)={e:.3g} kappa agreement {a:.6f} ok")
    # the operations these draws need: 23 per (kappa-arm draw, slot) for the
    # Gumbel noise (hash, two logs, the add and compare), 1 per (draw, slot)
    # for the membership compare; uniform-arm draws need no Gumbel noise
    sets = [(2000 + i, ti_, ts_) for i, (ts_, ti_) in enumerate(tops)]
    n_kappa = sum(int((fk.fused_sampler_cuda(sd, eps, ti_, ts_, **kw)[2] >= 0).sum())
                  for sd, ti_, ts_ in sets) / len(sets)
    log(f"  fused_sampler: {n_kappa:.1f} of {b * s} draws per call on the kappa arm "
        f"({n_kappa / (b * s):.4f}), mean over the timed inputs")
    res["fused_sampler"] = dict(max_abs_err=err, kappa_agreement=agree_min, **timed(
        f"fused_sampler B={b} S={s} K={k}",
        lambda sd, ti_, ts_: fk.fused_sampler_cuda(sd, eps, ti_, ts_, **kw),
        lambda sd, ti_, ts_: fr.fused_sampler_ref(sd, eps, ti_, ts_, **kw),
        sets, b * k * 8 + b * s * 12, n_kappa * k * 23 + b * s * k))

    # -- snis_covgrad forward and backward ------------------------------------
    ferr = berr = 0.0
    for bb, ss, ll, pp in [(4, 24, 16, 300), (3, 40, 256, 500), (5, 1000, 100, 2000)]:
        h = torch.randn((bb, ll), generator=gen, device=dev)
        bt = 0.3 * torch.randn((pp, ll), generator=gen, device=dev)
        a = torch.randint(0, pp, (bb, ss), generator=gen, device=dev).int()
        a[0, ::3] = -1
        a[-1] = -1
        lq = torch.where(a >= 0, torch.randn((bb, ss), generator=gen, device=dev) - 5, LOG_Q_PAD)
        r = (torch.rand((bb, ss), generator=gen, device=dev) < 0.3).float() * (a >= 0)
        for ts in (1, 8, 5):
            gk, wk, sck = so.snis_covgrad_fused(h, bt, a, lq, r, sample_tile=ts)
            sref, gref = sr.snis_fwd_ref(h, bt, a, lq, r, covgrad=True)
            ferr = max(ferr, close_err(sck, sref, "covgrad scores", sums=True),
                       close_err(gk, gref, "covgrad g", sums=True),
                       close_err(so.snis_scores_fused(h, bt, a, lq, r, sample_tile=ts), sref,
                                 "scores only", sums=True))
            check(bool((gk[-1] == 0).all()), "an all-masked row's gradient is not 0")
            cf = torch.randn((bb, ss), generator=gen, device=dev)
            cf[a < 0] = float("nan")
            berr = max(berr, close_err(so.snis_covgrad_bwd(cf, a, bt, sample_tile=ts),
                                       sr.snis_bwd_ref(cf, a, bt), "bwd", sums=True))
        log(f"  snis_covgrad small: B={bb} S={ss} L={ll} TS in (1, 8, 5), both modes, masked "
            f"slots, an all-masked row, NaN coefficients on dead lanes: ok")
    # the training shapes: the sampler's draws over the training top-K
    steps = []
    for i, (ts_, ti_) in enumerate(tops):
        a, lq, _ = fk.fused_sampler_cuda(3000 + i, eps, ti_, ts_, **kw)
        pos = torch.from_numpy(positives[i * b:(i + 1) * b]).to(dev)
        r = (a[:, :, None] == pos[:, None, :]).any(-1).float()
        cf = torch.randn((b, s), generator=gen, device=dev) * 1e-3
        steps.append((hs[i], a, lq, r, cf))
    for ts in (TS, 1):
        h, a, lq, r, cf = steps[0]
        sref, gref = sr.snis_fwd_ref(h, beta, a, lq, r, covgrad=True)
        gk, _, sck = so.snis_covgrad_fused(h, beta, a, lq, r, sample_tile=ts)
        ferr = max(ferr, close_err(sck, sref, "full scores", sums=True),
                   close_err(gk, gref, "full g", sums=True),
                   close_err(so.snis_scores_fused(h, beta, a, lq, r, sample_tile=ts), sref,
                             "full scores only", sums=True))
        berr = max(berr, close_err(so.snis_covgrad_bwd(cf, a, beta, sample_tile=ts),
                                   sr.snis_bwd_ref(cf, a, beta), "full bwd", sums=True))
        log(f"  snis_covgrad full: B={b} S={s} L={l} TS={ts} (training draws), both modes "
            f"and the backward: ok")
    rows = b * s * l * 4
    res["snis_covgrad_fwd"] = dict(max_abs_err=ferr, **timed(
        f"snis_covgrad_fwd scores-only B={b} S={s} L={l}",
        lambda h, a, lq, r, cf: sk.snis_fwd_cuda(h, beta, a, lq, r, covgrad=False),
        lambda h, a, lq, r, cf: sr.snis_fwd_ref(h, beta, a, lq, r, covgrad=False),
        steps, rows + b * s * 8 + b * l * 4, 2 * b * s * l))
    res["snis_covgrad_fwd_covgrad_mode"] = timed(
        f"snis_covgrad_fwd covgrad mode B={b} S={s} L={l}",
        lambda h, a, lq, r, cf: sk.snis_fwd_cuda(h, beta, a, lq, r, covgrad=True),
        lambda h, a, lq, r, cf: sr.snis_fwd_ref(h, beta, a, lq, r, covgrad=True),
        steps, rows + b * s * 16 + b * l * 8, 6 * b * s * l)
    res["snis_covgrad_bwd"] = dict(max_abs_err=berr, **timed(
        f"snis_covgrad_bwd B={b} S={s} L={l}",
        lambda h, a, lq, r, cf: sk.snis_bwd_cuda(cf, a, beta),
        lambda h, a, lq, r, cf: sr.snis_bwd_ref(cf, a, beta),
        steps, rows + b * s * 8 + b * l * 4, 2 * b * s * l,
        library_fn=lambda h, a, lq, r, cf: torch.nn.functional.embedding_bag(
            a, beta, per_sample_weights=cf, mode="sum"),
        library_note="embedding_bag(actions, beta, per_sample_weights=coeff, mode='sum')"))
    return res


def recording_plan(plan, record: list, replay: list | None = None):
    """A copy of ``plan`` that records each step's (top-K, draws); with
    ``replay`` (another run's records) the step goes on with that run's
    draws instead of its own, which are still recorded."""
    base = type(plan)

    class Recording(base):
        def _draw_mixture(self, seed, topk, eps):
            own = base._draw_mixture(self, seed, topk, eps)
            record.append((topk, own))
            if replay is None:
                return own
            theirs = replay[len(record) - 1][1]
            return type(own)(*(t.to(own.actions.device) for t in theirs))

    return Recording(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)})


def train_phase(ds, theta0) -> dict:
    """fopo-paper at full width through the kernel path on the card, the
    launch counts, step times and a profiled window; then the CPU replay
    of the first steps through the plain versions."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.fused_sampler import kernel as fk, ref as fr
    from repro_torch.kernels.ivf_topk import kernel as ik, ref as ir
    from repro_torch.kernels.mips_topk import kernel as mk, ref as mr
    from repro_torch.kernels.snis_covgrad import kernel as sk, ref as sr
    from repro_torch.train import FOPOTrainer, TrainerConfig

    paper = get_arch("fopo-paper").CONFIG
    fopo = dataclasses.replace(paper.fopo, retriever="pallas", fused=True, fused_sampler=True,
                               sample_tile=TS)
    cfg = TrainerConfig(estimator="fopo", fopo=fopo, batch_size=paper.batch_size,
                        learning_rate=paper.learning_rate, num_steps=TRAIN_STEPS, seed=0)
    seeds = np.random.default_rng(17).integers(0, 2**31 - 1, TRAIN_STEPS + PROFILED_STEPS)
    tr = FOPOTrainer(cfg, ds, device="cuda", params=theta0,
                     step_seeds=lambda step: int(seeds[step]))
    card_draws: list = []
    tr.plan = recording_plan(tr.plan, card_draws)
    w0 = tr.params["w"].clone()
    counters = [(mk.mips_topk_cuda, "launches"), (fk.fused_sampler_cuda, "launches"),
                (sk.snis_fwd_cuda, "launches"), (sk.snis_bwd_cuda, "launches"),
                (ik.ivf_probe_topk_cuda, "launches"), (mr.mips_topk_ref, "calls"),
                (fr.fused_sampler_ref, "calls"), (sr.snis_fwd_ref, "calls"),
                (sr.snis_bwd_ref, "calls"), (ir.ivf_probe_topk_ref, "calls")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    hist, thetas = {"loss": [], "ess": [], "rbar": [], "max_wbar": [], "step_time": []}, []
    for n in [1] * REPLAY_STEPS + [TRAIN_STEPS - REPLAY_STEPS]:
        h = tr.train(n)
        for key in hist:
            hist[key] += h[key]
        thetas.append(tr.params["w"].clone())
    counts = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
    log(f"[train] fopo-paper P={paper.num_items} L={paper.embed_dim} S={fopo.num_samples} "
        f"K={fopo.top_k} eps={fopo.epsilon} B={cfg.batch_size} lr={cfg.learning_rate}, "
        f"retriever=pallas fused fused_sampler TS={TS}: {TRAIN_STEPS} steps; counts {counts}")
    for fn in (mk.mips_topk_cuda, fk.fused_sampler_cuda, sk.snis_fwd_cuda, sk.snis_bwd_cuda):
        check(fn.launches == TRAIN_STEPS,
              f"{fn.__name__} launched {fn.launches} times in {TRAIN_STEPS} steps")
    check(ik.ivf_probe_topk_cuda.launches == 0, "ivf_topk ran on the training path")
    for fn in (mr.mips_topk_ref, fr.fused_sampler_ref, sr.snis_fwd_ref, sr.snis_bwd_ref,
               ir.ivf_probe_topk_ref):
        check(fn.calls == 0, f"the plain version {fn.__name__} ran {fn.calls} times on the card")
    for key in ("loss", "ess", "rbar", "max_wbar"):
        check(bool(np.all(np.isfinite(hist[key]))), f"non-finite {key}: {hist[key]}")
    moved = float((tr.params["w"] - w0).abs().max())
    check(moved > 0, "theta did not change")
    st = sorted(hist["step_time"][1:])
    p50, p99 = percentile(st, 50) * 1e3, percentile(st, 99) * 1e3
    log(f"[train] loss {hist['loss'][0]:+.5f} -> {hist['loss'][-1]:+.5f}, ess "
        f"{hist['ess'][0]:.1f} -> {hist['ess'][-1]:.1f}, rbar {hist['rbar'][0]:+.4f} -> "
        f"{hist['rbar'][-1]:+.4f}, max_wbar {hist['max_wbar'][-1]:.3f}; theta moved by up to "
        f"{moved:.3g}; step time p50 {p50:.3f} ms, p99 {p99:.3f} ms over steps 1-"
        f"{TRAIN_STEPS - 1} (step 0 {hist['step_time'][0] * 1e3:.3f} ms)")

    # where a step's device time goes: a profiled window of a few steps
    from torch.profiler import ProfilerActivity, profile

    # device activity only: each entry is a kernel, a copy or a fill, so
    # their times add up to the device's busy time without double counts
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(PROFILED_STEPS)
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    def device_us(ev) -> float:
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "device_time_total", 0.0)

    groups = {"mips_topk": 0.0, "fused_sampler": 0.0, "snis_fwd": 0.0, "snis_bwd": 0.0,
              "other": 0.0}
    for ev in prof.key_averages():
        dt = device_us(ev) / PROFILED_STEPS / 1e3
        if dt <= 0:
            continue
        name = ev.key
        group = ("mips_topk" if "mips_" in name else "fused_sampler" if "fused_sampler" in name
                 else "snis_fwd" if "snis_fwd" in name else "snis_bwd" if "snis_bwd" in name
                 else "other")
        groups[group] += dt
    busy = sum(groups.values())
    if busy > 0:
        log(f"[train] profiled {PROFILED_STEPS} steps: device ms per step by kernel: "
            + ", ".join(f"{k} {v:.4f}" for k, v in groups.items())
            + f"; busy {busy:.4f} of {wall:.4f} ms wall per step (profiled), device idle "
            f"{100 * (1 - busy / wall):.1f}%")
        other = sorted(((device_us(e) / PROFILED_STEPS / 1e3, e.key)
                        for e in prof.key_averages() if device_us(e) > 0), reverse=True)[:8]
        log("[train] top device entries (ms per step): "
            + "; ".join(f"{n[:48]} {t:.4f}" for t, n in other))
    else:
        log("[train] the profiler reported no device time on this machine")

    # the first steps again on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu_draws: list = []
    rep = FOPOTrainer(cfg, ds, device="cpu", params=theta0,
                      step_seeds=lambda step: int(seeds[step]))
    rep.plan = recording_plan(rep.plan, cpu_draws, replay=card_draws)
    kappa_agree, top_same = [], []
    for t in range(REPLAY_STEPS):
        h = rep.train(1)
        for key in ("loss", "ess", "rbar", "max_wbar"):
            close_err(torch.tensor(h[key]), torch.tensor(hist[key][t:t + 1]),
                      f"replay step {t} {key}")
        close_err(rep.params["w"], thetas[t], f"replay step {t} theta", rtol=0.0, atol=1e-6)
        (ctop, cs), (gtop, gs) = cpu_draws[t], card_draws[t]
        topk_err((gtop.scores, gtop.indices), (ctop.scores, ctop.indices),
                 f"replay step {t} top-K")
        gi, ci = gtop.indices.cpu(), ctop.indices
        top_same.append(float(np.mean([set(a.tolist()) == set(c.tolist())
                                       for a, c in zip(gi, ci)])))
        kappa = gs.topk_slot.cpu() >= 0
        kappa_agree.append(float((gs.actions.cpu()[kappa] == cs.actions[kappa]).float().mean()))
        check(bool(torch.equal(gs.topk_slot.cpu() == -1, cs.topk_slot == -1)),
              f"replay step {t}: arm choice differs")
        # not every draw: fp32 sums taken in another order swap near-tied
        # scores in the top-K order, and a draw at a swapped slot takes the
        # other item; a broken sampler would agree on almost none
        check(kappa_agree[-1] >= 0.99, f"replay step {t}: kappa agreement {kappa_agree[-1]}")
    log(f"[train] CPU replay of steps 0-{REPLAY_STEPS - 1} through the plain versions "
        f"({time.perf_counter() - t0:.1f} s): loss and diagnostics within rtol {RTOL} / atol "
        f"{ATOL}, theta within 1e-6 of the card's at every step, on the card's draws; the "
        f"CPU's own retrieval against the card's at every step: sorted scores within rtol "
        f"{RTOL} / atol {ATOL}, ids as sets but for boundary ties (rows equal as sets "
        f"{top_same}); the CPU's own draws: kappa-arm agreement {kappa_agree} (held >= "
        f"0.99), uniform arm exact")
    return dict(counts=counts, p50_ms=p50, p99_ms=p99, kappa_agreement=min(kappa_agree))


def percentile(values: list[float], p: float) -> float:
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, round(p / 100.0 * (len(vs) - 1))))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one GPU",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_topk import kernel, ops, ref
    from repro_torch.mips.exact import TopK, recall_at_k, topk_exact
    from repro_torch.mips.refresh import RefreshState
    from repro_torch.models import recsys
    from repro_torch.serve import CoalescePolicy, RecsysMIPSRoute, ServingEngine

    # 1. environment
    card = card_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[env] card: {card}")

    # 2. build: every kernel's source, one nvcc each, all started together
    from repro_torch.kernels.fused_sampler import kernel as fk
    from repro_torch.kernels.mips_topk import kernel as mk
    from repro_torch.kernels.snis_covgrad import kernel as sk

    sources = [kernel.SOURCE, mk.SOURCE, fk.SOURCE, sk.FWD_SOURCE, sk.BWD_SOURCE]
    t0 = time.perf_counter()
    _build.build(sources)
    for lib in (kernel.library, mk.library, fk.library, sk.fwd_library, sk.bwd_library):
        lib()
    log(f"[build] {', '.join(str(x.relative_to(ROOT)) for x in sources)} built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")

    # the serving route at full width: weights, tower, IVF index
    dev = torch.device("cuda")
    cfg = get_arch("sasrec").CONFIG
    gen = torch.Generator(device=dev).manual_seed(0)
    params = recsys.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route = RecsysMIPSRoute(cfg, params, k=K_SERVE, n_probe=N_PROBE, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    planner = route.planner
    state = planner.index_state
    index = state.as_index(cfg.item_vocab)
    c, cap = state.lists.shape
    log(f"[serve] {cfg.name}: items {cfg.item_vocab} x {cfg.embed_dim}, "
        f"index built in {build_s:.2f} s: C={c}, cap={cap}, list_embs "
        f"{state.list_embs.numel() * 4 / 1e6:.1f} MB, n_probe={planner.n_probe}")

    rng = np.random.default_rng(0)
    payloads = [rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
                for _ in range(REQUESTS)]
    with torch.inference_mode():
        users = [
            recsys.sasrec_user_vector(
                cfg, planner.params,
                torch.from_numpy(np.stack(payloads[i:i + MAX_BATCH])).to(dev),
            ).contiguous()
            for i in range(0, REQUESTS, MAX_BATCH)
        ]

    # 3. kernels vs plain versions
    log("[kernels] ivf_topk vs its plain version, on the card "
        f"(scores rtol={RTOL}, atol={ATOL}; ids as sets)")
    with torch.inference_mode():
        kres = kernel_phase(index, state, users)

    # 4. drive the serving path; counts set to 0 just before, read just after
    engine = ServingEngine(route, CoalescePolicy(max_batch=MAX_BATCH, max_wait_s=0.002))
    engine.warmup()
    kernel.ivf_probe_topk_cuda.launches = 0
    ref.ivf_probe_topk_ref.calls = 0
    for p in payloads:
        engine.submit(p, arrival=0.0)
    records = engine.drain()
    launches = kernel.ivf_probe_topk_cuda.launches
    plain_calls = ref.ivf_probe_topk_ref.calls
    check(len(records) == REQUESTS, f"answered {len(records)}/{REQUESTS}")
    check(launches == 2 * engine.batches,
          f"ivf_topk launched {launches} times for {engine.batches} batches "
          "(expected main + delta per batch)")
    check(plain_calls == 0, f"the plain version ran {plain_calls} times on the card")
    check(not route.degraded, "the serving path fell back to exact search")
    lats = [r.latency for r in records]
    makespan = max(r.finish for r in records) - min(r.arrival for r in records)
    log(f"[serve] {len(records)}/{REQUESTS} answered in {engine.batches} batches "
        f"(occupancy {engine.occupancy():.2f}); ivf_topk launches {launches}, "
        f"plain-version calls {plain_calls}, fallback taken: no")
    log(f"[serve] latency p50 {percentile(lats, 50) * 1e3:.3f} ms, p99 "
        f"{percentile(lats, 99) * 1e3:.3f} ms, {len(records) / makespan:.1f} req/s "
        f"(qps=0: all {REQUESTS} arrive at t=0)")

    # the answers against the plain path on the CPU, from the same users
    cpu_state = RefreshState(*(t.cpu() for t in state))
    got_ids = np.stack([r.result[0] for r in records])
    got_scores = np.stack([r.result[1] for r in records])
    for i, h in enumerate(users):
        exp = ops.ivf_topk(h.cpu(), cpu_state.as_index(cfg.item_vocab), K_SERVE,
                           n_probe=planner.n_probe, delta=cpu_state.delta())
        rows = slice(i * MAX_BATCH, (i + 1) * MAX_BATCH)
        served = (torch.from_numpy(got_scores[rows]).cuda(),
                  torch.from_numpy(got_ids[rows]).cuda())
        topk_err(served, (exp.scores.cuda(), exp.indices.cuda()), f"serve batch {i}")
    check(bool(((got_ids >= 0) & (got_ids < cfg.item_vocab)).all()), "served ids out of range")
    with torch.inference_mode():
        h_all = torch.cat(users)
        exact = topk_exact(h_all, planner.beta, K_SERVE)
    served_all = TopK(torch.from_numpy(got_scores), torch.from_numpy(got_ids))
    log(f"[serve] answers match the plain path on the CPU (64/64); recall@{K_SERVE} "
        f"against exact search {recall_at_k(served_all, exact):.3f} (random weights)")
    stage_times(route, payloads, records)

    # 5. the training path at full fopo-paper width
    ds, theta0, beta, h0 = training_data(dev)
    log("[kernels] the training kernels vs their plain versions, on the card (rtol="
        f"{RTOL}, atol={ATOL}; for the sampled scores, g and grad_h, sums of terms of both "
        "signs, atol scaled by max |output|; top-K ids as sets; sampler draws exact on the "
        "uniform arm, kappa arm >= 0.999, log q within 1e-6)")
    with torch.no_grad():
        tk = training_kernel_phase(beta, h0, ds.positives)
    del beta, h0
    tres = train_phase(ds, theta0)

    # 6. the kernels line, the card, the result
    t = kres["timing"]["main K=10"]
    entries = [{
        "name": "ivf_topk",
        "route": "cuda",
        "source": str(kernel.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ivf_topk/kernel.py:86",
        "launches": launches,
        "max_abs_err": kres["max_abs_err"],
        "ms": t["ms"],
        "kernel_ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]
    for name, source, replaces, launch_fn in [
        ("mips_topk", mk.SOURCE, "src/repro/kernels/mips_topk/kernel.py:72", mk.mips_topk_cuda),
        ("fused_sampler", fk.SOURCE, "src/repro/kernels/fused_sampler/kernel.py:172",
         fk.fused_sampler_cuda),
        ("snis_covgrad_fwd", sk.FWD_SOURCE, "src/repro/kernels/snis_covgrad/kernel.py:259",
         sk.snis_fwd_cuda),
        ("snis_covgrad_bwd", sk.BWD_SOURCE, "src/repro/kernels/snis_covgrad/backward.py:137",
         sk.snis_bwd_cuda),
    ]:
        r = tk[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": str(source.relative_to(ROOT)),
            "replaces": replaces,
            "launches": tres["counts"][f"{launch_fn.__name__}.launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
