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
                  it (ivf_topk also at the LM route's width, L 2304, and
                  at widths not a multiple of 4), within the CPU parity
                  tests' tolerances; times of
                  the kernel and the plain version (device time per call
                  from a replayed CUDA graph, and time per eager call),
                  the library call where one computes the same function,
                  and the least time the card could take for the same
                  work (bytes over 3.35 TB/s or operations over their
                  type's peak rate, the larger)
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
  6. flash        the flash-attention kernel (K9) against its plain
                  version in fp32 and bf16, out and lse: small shapes
                  (ragged S, windows 8 / 64, cap 50, q_offset > 0, GQA
                  n_rep 1 and 2, every head width), the training path's
                  microbatch (B 1, H 8, KV 4, S 2048, D 256, fp32 and
                  bf16), the Gemma-2 prefill shape (B 8, same heads,
                  bf16) and S 8192 at batch 1 with window 4096; times and
                  bounds (at the prefill and S 8192 shapes), and at
                  the prefill shape torch's flex_attention, compiled, as
                  the library yardstick (in bf16 and on the fp32 upcast)
  7. flash bwd    the flash-attention backward kernel (K10) against its
                  plain version in fp32 and bf16, dq, dk and dv, with lse
                  and D from K9's plain version: small shapes (ragged S,
                  windows 8 / 64, cap 50, q_offset > 0, GQA n_rep 1 and 2,
                  every head width), the Gemma-2 training shape (B 4, H 8,
                  KV 4, S 2048, D 256; also B 1, the main path's
                  microbatch) and S 8192 at batch 1 with window 4096;
                  times and bounds, and at the training shape torch's
                  flex_attention forward + backward, compiled, as the
                  library yardstick beside K9 + K10
  8. lm           the Gemma-2 2B generation path at full width (26 layers,
                  d_model 2304, vocab 256,000, bf16; random weights from a
                  seed; use_flash_kernel=True): `LMGenerateRoute` builds
                  its IVF index over the unembed rows, a `ServingEngine`
                  with max_batch=8 answers 16 requests of a 2048-token
                  prompt and 16 generated tokens; the launch counters show
                  26 K9 launches per prefill batch, ivf_topk on every
                  token and no plain version; stage times, step p50 / p99,
                  a profiled batch's device idle share, ivf_topk at the LM
                  shape; then the gate against the plain chunked attention
                  (use_flash_kernel=False) on the card: the prefill hidden
                  states in bf16, a teacher-forced decode step by step
                  (token disagreements only at near ties), and one prefill
                  batch in fp32 within rtol 1e-4
  9. lm-train     Gemma-2 2B training at full width (26 layers, d_model
                  2304, vocab 256,000; bf16 parameters from a seed, remat
                  on, use_flash_kernel=True): `lm.make_train_step` with
                  Adam(1e-3) takes 6 steps of a global batch of 4 x 2048
                  tokens in 4 strided microbatches of one row; step 1 runs
                  on the bf16 parameters, Adam then promotes them to fp32
                  (the reference's dtype rule, checked after every step);
                  the launch counters show 208 K9 and 104 K10 launches per
                  step and no plain version; step 1's time, the fp32
                  steps' p50 / p99, tokens/s, peak device memory and a
                  profiled step's device idle share; then the gate at 4
                  layers of the full width: one step each through the
                  kernels and through the plain chunked attention from the
                  same parameters and tokens, in bf16 (loss within 1e-2
                  relative, every gradient leaf within 5e-2 relative L2)
                  and in fp32 (1e-5, 1e-4)
 10. a JSON line of the kernels, then the card's name and power limit,
     then the last line {"ok": true, "device": {...}}

Any failed check raises, and the script exits non-zero without the last
line; it also exits non-zero when CUDA is not available.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
RTOL, ATOL = 1e-5, 1e-6  # the CPU parity tests' score tolerances
N_PROBE, K_SERVE, MAX_BATCH, REQUESTS = 8, 10, 8, 64
TRAIN_STEPS, REPLAY_STEPS, PROFILED_STEPS, TS = 20, 3, 3, 8
LM_PROMPT, LM_GEN, LM_BATCH, LM_REQUESTS, LM_TOP_K = 2048, 16, 8, 16, 4
BF16_RTOL = 2.0**-7  # one bf16 ulp at the bottom of a binade
LM_HIDDEN_REL = 5e-2  # bf16 prefill hidden states, kernel vs plain path (relative L2)
# LM training: global batch 4 x 2048 in microbatches of 1 row, 6 Adam steps
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_MICRO, LM_TRAIN_STEPS, LM_GATE_LAYERS = 4, 2048, 1, 6, 4
# the training gate, kernel vs plain attention: (loss relative, gradient leaf relative L2)
GATE_BF16, GATE_FP32 = (1e-2, 5e-2), (1e-5, 1e-4)


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

    # the LM route's width (L 2304 = the Gemma-2 hidden, C 512, K 4, B 8,
    # n_probe 8), streamed in 72 slices of 32 columns; and widths that are
    # not a multiple of 4 (4-byte copies, a partial last slice)
    for c, capp, l, b, n_probe, k in [(512, 512, 2304, 8, 8, 4), (16, 200, 2302, 3, 4, 10),
                                      (8, 100, 7, 2, 3, 5)]:
        lists = torch.randperm(c * capp, generator=gen, device=dev).reshape(c, capp)
        lists = torch.where(torch.rand((c, capp), generator=gen, device=dev) < 0.25,
                            -1, lists).to(torch.int32)
        embs = (torch.randn((c, capp, l), generator=gen, device=dev) / l**0.5
                * (lists >= 0)[..., None]).contiguous()
        q = torch.randn((b, l), generator=gen, device=dev)
        probe = torch.stack([torch.randperm(c, generator=gen, device=dev)[:n_probe]
                             for _ in range(b)]).to(torch.int32)
        compare(f"wide L={l}", q, probe, lists, embs, k)
        if l == 2304:  # time it: 75 % of the slots live, read in 36 slices of 64 columns
            sets = [(torch.randn((b, l), generator=gen, device=dev), torch.stack(
                [torch.randperm(c, generator=gen, device=dev)[:n_probe] for _ in range(b)]
            ).to(torch.int32), lists, embs, k) for _ in range(4)]
            t_k, t_p = (device_ms(f, sets) for f in (kernel.ivf_probe_topk_cuda,
                                                     ref.ivf_probe_topk_ref))
            b_ms, b_by, nbytes = bound_ms(*sets[0])
            log(f"  time wide L={l}: device ms per call (CUDA graph) kernel {t_k:.4f}, plain "
                f"{t_p:.4f}; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} MB); kernel "
                f"device time at {100 * b_ms / t_k:.1f}% of the bound")
            del sets
        del lists, embs

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


# ---------------------------------------------------------------------------
# flash attention (K9): kernel vs plain version
# ---------------------------------------------------------------------------

def live_pairs(sq: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """Unmasked (query, key) pairs of one head: what the kernel must
    compute (the masked ones it skips or discards)."""
    import numpy as np

    qpos = q_offset + np.arange(sq)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound(b, sq, skv, h, kv, d, itemsize, causal, window, q_offset) -> tuple:
    """(ms, "bytes" or "operations", bytes, qk flops, pv flops): q, k, v
    read once, out and lse written once; 2 D flops per unmasked (query,
    key) pair for each product. q k^T of bf16 inputs at the bf16
    tensor-core rate (a product of two bf16 values is exact in fp32, so
    the tensor cores give it to fp32 accuracy), of fp32 inputs at the
    fp32 rate; p v at the fp32 rate (p is fp32). The two times add."""
    nbytes = (2 * b * sq * h * d + 2 * b * skv * kv * d) * itemsize + b * h * sq * 4
    qk = pv = b * h * live_pairs(sq, skv, causal, window, q_offset) * 2 * d
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = (qk / (BF16_FLOPS if itemsize == 2 else FP32_FLOPS) + pv / FP32_FLOPS) * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, qk, pv


def flex_setup(kw: dict, q):
    """(compiled flex_attention, the soft-cap score_mod or None, the block
    mask of the causal mask and window) for the library yardsticks, over
    q's [B, S, H, D] sequence length. Inductor's and Triton's caches go
    to the git-ignored build directory; one compile worker, none left
    behind."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from repro_torch.kernels import _build

    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(_build.BUILD_DIR / sub))
    import torch._inductor.config

    torch._inductor.config.compile_threads = 1
    cap, window, causal = kw.get("logit_cap"), kw.get("window"), kw.get("causal", True)

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        live = (ki <= qi) if causal else (ki >= 0)
        return live & (qi - ki < window) if window else live

    s_ = q.shape[1]
    block_mask = create_block_mask(mask_mod, None, None, s_, s_, device=q.device)
    return torch.compile(flex_attention, dynamic=False), score_mod if cap else None, block_mask


def flex_yardstick(sets: list, plain, kw: dict) -> dict:
    """K9's library call: torch's `flex_attention`, compiled, with the
    soft-cap as a score_mod, the causal mask and window as a block mask,
    enable_gqa and the lse requested (a yardstick only: the port never calls
    it). Timed on the same bf16 inputs (p is rounded to bf16 before p v:
    held to the plain version within relative L2 1e-2) and on their fp32
    upcast (the kernel's arithmetic: held within rtol 1e-4, atol 1e-5
    max |out|), in [B, H, S, D] layout. Returns {"bf16"|"fp32": ms or the
    error it raised or the disagreement}."""
    import torch
    from torch.nn.attention.flex_attention import AuxRequest

    flex, score_mod, block_mask = flex_setup(kw, sets[0][0])
    cap = kw.get("logit_cap")
    res = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        try:
            args = [tuple(x.transpose(1, 2).to(dtype).contiguous() for x in st) for st in sets]

            def call(q, k, v):
                return flex(q, k, v, score_mod=score_mod, block_mask=block_mask,
                            enable_gqa=True, return_aux=AuxRequest(lse=True))

            out, aux = call(*args[0])
            lse = aux.lse
            want, want_lse = plain(*(x.to(dtype) for x in sets[0]), **kw)
            out = out.transpose(1, 2).float()
            want = want.float()
            rel, err = rel_l2(out, want), float((out - want).abs().max())
            lerr = float((lse - want_lse).abs().max())
            ok = rel <= 1e-2 if dtype == torch.bfloat16 else bool(
                ((out - want).abs() <= 1e-5 * want.abs().max() + 1e-4 * want.abs()).all())
            del out, aux, lse, want, want_lse
            t = device_ms(call, args, calls=8, replays=5)
            log(f"  library {tag}: flex_attention (compiled) {t:.4f} ms per call (CUDA graph); "
                f"against the plain version: out relative L2 {rel:.3g}, max abs {err:.3g}, lse "
                f"max abs {lerr:.3g}: {'agrees' if ok else 'DISAGREES (not used)'}")
            res[tag] = t if ok else f"disagrees: out relative L2 {rel:.3g}, max abs {err:.3g}"
            del args
        except Exception as e:  # noqa: BLE001 — a yardstick, not a check of the port
            msg = f"{type(e).__name__}: {str(e).splitlines()[0][:300] if str(e) else ''}"
            log(f"  library {tag}: flex_attention (compiled) did not run: {msg}")
            res[tag] = msg
        torch.cuda.empty_cache()
    return res


def flash_phase() -> dict:
    """K9 against its plain version on the card, fp32 and bf16, out and
    lse, at small shapes and at the training path's B 1 x S 2048; times at
    the Gemma-2 prefill shape and at S 8192 with window 4096."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = {"out_fp32": 0.0, "out_bf16": 0.0, "lse": 0.0}

    def inputs(b, sq, skv, h, kv, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))

    def plain(q, k, v, **kw):
        b, sq, h, d = q.shape
        n_rep = h // k.shape[2]
        fold = lambda x, r: x.transpose(1, 2).repeat_interleave(r, 1).reshape(b * h, -1, d)  # noqa: E731
        out, lse = fr.flash_attention_ref(fold(q, 1), fold(k, n_rep), fold(v, n_rep), **kw)
        return out.reshape(b, h, sq, d).transpose(1, 2), lse.reshape(b, h, sq)

    def compare(tag, q, k, v, **kw):
        out, lse = fk.flash_attention_fwd_cuda(q, k, v, **kw)
        ro, rl = plain(q, k, v, **kw)
        if q.dtype == torch.bfloat16:
            e = close_err(out, ro, tag + " out", rtol=BF16_RTOL, atol=ATOL)
            errs["out_bf16"] = max(errs["out_bf16"], e)
        else:
            e = close_err(out, ro, tag + " out", sums=True)
            errs["out_fp32"] = max(errs["out_fp32"], e)
        el = close_err(lse, rl, tag + " lse", atol=1e-5)
        errs["lse"] = max(errs["lse"], el)
        b, sq, h, d = q.shape
        log(f"  {tag}: B={b} Sq={sq} Skv={k.shape[1]} H={h} KV={k.shape[2]} D={d} "
            f"{str(q.dtype)[6:]} {kw}: out max_abs_err {e:.3g}, lse {el:.3g} ok")

    for dtype in (torch.float32, torch.bfloat16):
        for d in fk.HEAD_DIMS:
            compare("small", *inputs(2, 77, 77, 4, 2, d, dtype), logit_cap=50.0)
        compare("small", *inputs(1, 300, 300, 2, 2, 64, dtype), window=64)
        compare("small", *inputs(1, 130, 130, 4, 2, 16, dtype), window=8, logit_cap=50.0)
        compare("small", *inputs(1, 40, 130, 4, 2, 128, dtype), window=8, q_offset=90,
                logit_cap=50.0)
        compare("small", *inputs(2, 100, 100, 2, 1, 256, dtype), causal=False)
        # the training path's shape: one row of LM_TRAIN_S tokens per microbatch
        compare("training B 1", *inputs(1, LM_TRAIN_S, LM_TRAIN_S, 8, 4, 256, dtype),
                logit_cap=50.0)

    timing = {}
    for tag, (b, s_, h, kv, d), kw in [
        ("gemma prefill", (LM_BATCH, LM_PROMPT, 8, 4, 256), dict(logit_cap=50.0)),
        ("gemma prefill local", (LM_BATCH, LM_PROMPT, 8, 4, 256),
         dict(logit_cap=50.0, window=4096)),
        ("S 8192 window 4096", (1, 8192, 8, 4, 256), dict(logit_cap=50.0, window=4096)),
    ]:
        sets = [inputs(b, s_, s_, h, kv, d, torch.bfloat16) for _ in range(2)]
        compare(tag, *sets[0], **kw)
        kern = lambda q, k, v: fk.flash_attention_fwd_cuda(q, k, v, **kw)  # noqa: E731
        ref_ = lambda q, k, v: plain(q, k, v, **kw)  # noqa: E731
        t_k = device_ms(kern, sets, calls=8, replays=5)
        t_p = device_ms(ref_, sets, calls=2, replays=3)
        e_k = time_ms(kern, sets, 10)
        b_ms, b_by, nbytes, qk, pv = flash_bound(b, s_, s_, h, kv, d, 2, True,
                                                 kw.get("window"), 0)
        timing[tag] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"  time {tag} (B={b} S={s_} H={h} KV={kv} D={d} bf16 {kw}): device ms per call "
            f"(CUDA graph) kernel {t_k:.4f}, plain {t_p:.4f}; eager kernel {e_k:.4f}; bound "
            f"{b_ms:.4f} ms ({b_by}: q k^T {qk / 1e9:.2f} GFLOP at the bf16 tensor-core rate, "
            f"{qk / BF16_FLOPS * 1e3:.4f} ms, + p v {pv / 1e9:.2f} GFLOP at the fp32 rate, "
            f"{pv / FP32_FLOPS * 1e3:.4f} ms; {nbytes / 1e6:.2f} MB, "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); kernel at {100 * b_ms / t_k:.1f}% of "
            "the bound")
        if tag == "gemma prefill":
            lib = flex_yardstick(sets, plain, kw)
            timing[tag]["library"] = lib
            if isinstance(lib["bf16"], float):
                timing[tag]["library_ms"] = lib["bf16"]
        del sets
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), errs=errs, timing=timing)



# ---------------------------------------------------------------------------
# flash attention backward (K10): kernel vs plain version
# ---------------------------------------------------------------------------

def flash_bwd_bound(b, sq, skv, h, kv, d, itemsize, causal, window, q_offset) -> tuple:
    """(ms, "bytes" or "operations", bytes, flops at the bf16 rate, flops at
    the fp32 rate): q, k, v, dO, lse and D read once, dq, dk, dv written
    once; 10 D flops per unmasked (query, key) pair, five D-long products
    (s, dp, dv, dq, dk). With bf16 inputs q k^T and dO v^T multiply bf16
    values (exact in fp32) and run at the bf16 tensor-core rate, the
    other three (p and ds are fp32) at the fp32 rate; with fp32 inputs all
    five at the fp32 rate. The bound is the larger of the two times."""
    nbytes = (3 * b * sq * h * d + 4 * b * skv * kv * d) * itemsize + 2 * b * h * sq * 4
    pairs = b * h * live_pairs(sq, skv, causal, window, q_offset)
    at_bf16 = 4 * d * pairs if itemsize == 2 else 0
    at_fp32 = 10 * d * pairs - at_bf16
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = (at_bf16 / BF16_FLOPS + at_fp32 / FP32_FLOPS) * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, at_bf16, at_fp32


def flex_fwd_bwd_yardstick(sets: list, kw: dict, plain_grads) -> dict:
    """The library call beside K9 + K10: torch's `flex_attention`,
    compiled, forward and backward in bf16 (soft-cap as a score_mod, the
    causal mask and window as a block mask, enable_gqa; a yardstick only:
    the port never calls it), [B, H, S, D] layout. Its gradients are held
    to the plain versions' within relative L2 2e-2 (flex rounds p and ds
    to bf16 for its tensor-core products). Timed with CUDA events around
    eager calls, as is the port's own forward + backward beside it.
    Returns {"ms": ms or None, "port_ms": ms, "note": str}."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fo

    def port(q, k, v, do):
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        fo.flash_attention(q, k, v, **kw).backward(do)
        return q.grad, k.grad, v.grad

    port_ms = time_ms(port, sets, 6)
    res = {"ms": None, "port_ms": port_ms}
    try:
        flex, score_mod, block_mask = flex_setup(kw, sets[0][0])

        def call(q, k, v, do):
            q, k, v = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            out = flex(q, k, v, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
            out.backward(do.transpose(1, 2))
            return tuple(x.grad.transpose(1, 2) for x in (q, k, v))

        got = call(*sets[0])
        rels = [rel_l2(a, b) for a, b in zip(got, plain_grads)]
        del got
        ok = max(rels) <= 2e-2
        t = time_ms(call, sets, 6)
        res["ms"] = t if ok else None
        res["note"] = (f"flex_attention (compiled) forward + backward {t:.4f} ms per call "
                       f"(eager, CUDA events); dq, dk, dv relative L2 from the plain versions "
                       f"{', '.join(f'{r:.3g}' for r in rels)}: "
                       f"{'agrees' if ok else 'DISAGREES (not used)'}")
    except Exception as e:  # noqa: BLE001 — a yardstick, not a check of the port
        res["note"] = ("flex_attention forward + backward did not run: "
                       f"{type(e).__name__}: {str(e).splitlines()[0][:300] if str(e) else ''}")
    log(f"  library: {res['note']}; the port's K9 + K10 forward + backward {port_ms:.4f} ms "
        "per call (eager, CUDA events)")
    torch.cuda.empty_cache()
    return res


def flash_bwd_phase(dev=None) -> dict:
    """K10 against its plain version on the card, fp32 and bf16, dq, dk and
    dv, with lse and D from K9's plain version: small shapes, the
    training shape (B 4 and the main path's microbatch of B 1) and S 8192
    at batch 1 with window 4096; times and bounds, and the library
    yardstick at the training shape."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr

    dev = torch.device(dev or "cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {"fp32": 0.0, "bf16": 0.0}

    def fold(x, r):
        b, s_, n, d = x.shape
        return x.transpose(1, 2).repeat_interleave(r, 1).reshape(b * n * r, s_, d)

    def inputs(b, sq, skv, h, kv, d, dtype, **kw):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for shape in (
            (b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d)))
        out, lse = fr.flash_attention_ref(fold(q, 1), fold(k, h // kv), fold(v, h // kv), **kw)
        out = out.reshape(b, h, sq, d).transpose(1, 2)
        dsum = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse.reshape(b, h, sq), dsum

    def plain(q, k, v, do, lse, dsum, **kw):
        """The plain version on the inputs' fp32 values, the GQA group
        summed in fp32 and each output rounded once to the inputs' dtype:
        the function the kernel computes."""
        b, sq, h, d = q.shape
        skv, kv = k.shape[1], k.shape[2]
        n = h // kv
        dq, dk, dv = fr.flash_attention_bwd_ref(
            fold(q.float(), 1), fold(k.float(), n), fold(v.float(), n), fold(do.float(), 1),
            lse.reshape(b * h, sq), dsum.reshape(b * h, sq), **kw)
        def group(x):  # the GQA group sum, in fp32, rounded once
            return x.reshape(b, kv, n, skv, d).sum(2).transpose(1, 2).to(q.dtype)

        return dq.reshape(b, h, sq, d).transpose(1, 2).to(q.dtype), group(dk), group(dv)

    def compare(tag, args, **kw):
        got = fk.flash_attention_bwd_cuda(*args, **kw)
        want = plain(*args, **kw)
        bf16 = args[0].dtype == torch.bfloat16
        es = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if bf16:  # one bf16 ulp, atol for fp32 sums of both signs in another order
                scale = float(w.float().abs().max())
                es.append(close_err(g, w, f"{tag} {name}", rtol=BF16_RTOL,
                                    atol=ATOL + RTOL * scale))
            else:
                es.append(close_err(g, w, f"{tag} {name}", sums=True))
        key = "bf16" if bf16 else "fp32"
        errs[key] = max(errs[key], *es)
        q, k = args[0], args[1]
        log(f"  {tag}: B={q.shape[0]} Sq={q.shape[1]} Skv={k.shape[1]} H={q.shape[2]} "
            f"KV={k.shape[2]} D={q.shape[3]} {key} {kw}: max_abs_err dq {es[0]:.3g}, dk "
            f"{es[1]:.3g}, dv {es[2]:.3g} ok")
        del got, want
        return args

    for dtype in (torch.float32, torch.bfloat16):
        for d in fk.HEAD_DIMS:
            compare("small", inputs(2, 77, 77, 4, 2, d, dtype, logit_cap=50.0), logit_cap=50.0)
        compare("small", inputs(1, 300, 300, 2, 2, 64, dtype, window=64), window=64)
        compare("small", inputs(1, 130, 130, 4, 2, 16, dtype, window=8, logit_cap=50.0),
                window=8, logit_cap=50.0)
        kw = dict(window=8, q_offset=90, logit_cap=50.0)
        compare("small", inputs(1, 40, 130, 4, 2, 128, dtype, **kw), **kw)
        compare("small", inputs(2, 100, 100, 2, 1, 256, dtype, causal=False), causal=False)

    timing = {}
    gemma = dict(logit_cap=50.0)
    for tag, (b, s_, h, kv, d), kw, dtypes in [
        ("training B 4", (4, LM_PROMPT, 8, 4, 256), gemma, (torch.bfloat16, torch.float32)),
        ("training B 4 local", (4, LM_PROMPT, 8, 4, 256), dict(gemma, window=4096),
         (torch.bfloat16,)),
        ("main path B 1", (1, LM_PROMPT, 8, 4, 256), gemma, (torch.float32, torch.bfloat16)),
        ("S 8192 window 4096", (1, 8192, 8, 4, 256), dict(gemma, window=4096),
         (torch.bfloat16, torch.float32)),
    ]:
        for dtype in dtypes:
            sets = [inputs(b, s_, s_, h, kv, d, dtype, **kw) for _ in range(2)]
            compare(tag, sets[0], **kw)
            kern = lambda *a: fk.flash_attention_bwd_cuda(*a, **kw)  # noqa: E731
            ref_ = lambda *a: plain(*a, **kw)  # noqa: E731
            t_k = device_ms(kern, sets, calls=6, replays=4)
            t_p = device_ms(ref_, sets, calls=2, replays=3)
            item = 2 if dtype == torch.bfloat16 else 4
            b_ms, b_by, nbytes, f16, f32 = flash_bwd_bound(b, s_, s_, h, kv, d, item, True,
                                                           kw.get("window"), 0)
            key = f"{tag} {'bf16' if item == 2 else 'fp32'}"
            timing[key] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            log(f"  time {key} (B={b} S={s_} H={h} KV={kv} D={d} {kw}): device ms per call "
                f"(CUDA graph) kernel {t_k:.4f}, plain {t_p:.4f}; bound {b_ms:.4f} ms ({b_by}: "
                f"{f16 / 1e9:.2f} GFLOP at the bf16 tensor-core rate + {f32 / 1e9:.2f} GFLOP at "
                f"the fp32 rate; {nbytes / 1e6:.2f} MB, {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
                f"kernel at {100 * b_ms / t_k:.1f}% of the bound")
            if key == "training B 4 bf16":
                grads = plain(*sets[0], **kw)
                lib = flex_fwd_bwd_yardstick([st[:4] for st in sets], kw, grads)
                del grads
                timing[key]["library"] = lib
            del sets
            torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), errs=errs, timing=timing)


# ---------------------------------------------------------------------------
# the LM generation path (Gemma-2 2B at full width)
# ---------------------------------------------------------------------------

def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def near_tie(h1, h2, a: int, b: int, unembed, centroids, n_probe: int) -> tuple[bool, str]:
    """Whether two paths' different greedy tokens a (path 1) and b (path
    2) sit at a near tie. Token scores: (h1 - h2) moves s(a) - s(b) by at
    most |h1 - h2| |u_a - u_b|, so a gap under h1 within that can flip.
    Retrieval: if the two hidden states probe different clusters, the
    n_probe-th and next centroid scores under h1 must sit within
    |h1 - h2| times the largest centroid norm of each other."""
    import torch

    h1, h2 = h1.float(), h2.float()
    dh = float((h1 - h2).norm())
    du = unembed[a].float() - unembed[b].float()
    gap = float(h1 @ du)
    if abs(gap) <= dh * float(du.norm()) * 1.001 + 1e-6:
        return True, f"token gap {gap:.4g} <= |dh| |du| = {dh * float(du.norm()):.4g}"
    c1 = h1 @ centroids.float().T
    c2 = h2 @ centroids.float().T
    p1 = set(torch.topk(c1, n_probe).indices.tolist())
    p2 = set(torch.topk(c2, n_probe).indices.tolist())
    if p1 != p2:
        top = torch.topk(c1, n_probe + 1).values
        cgap = float(top[n_probe - 1] - top[n_probe])
        cbound = 2 * dh * float(centroids.float().norm(dim=1).max())
        return cgap <= cbound, f"probe sets differ, centroid gap {cgap:.4g} (bound {cbound:.4g})"
    return False, f"token gap {gap:.4g} > |dh| |du| = {dh * float(du.norm()):.4g}"


def lm_phase(cfg=None, dev=None) -> dict:
    """The Gemma-2 2B generation path at full width on the card: the
    engine's run with its launch counts, stage times, a profiled batch,
    ivf_topk at the LM shape, and the gate against the plain path.
    (``cfg`` and ``dev`` default to the full CONFIG and the card.)"""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.ivf_topk import kernel as ik, ref as ir
    from repro_torch.models import lm
    from repro_torch.serve import CoalescePolicy, LMGenerateRoute, ServingEngine

    dev = torch.device(dev or "cuda")
    cfg = dataclasses.replace(cfg or get_arch("gemma2-2b").CONFIG, use_flash_kernel=True)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm"))
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.dh}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window} on even layers, caps "
        f"{cfg.attn_logit_softcap}/{cfg.final_logit_softcap}, {cfg.dtype}: {n_params / 1e9:.3f} B "
        f"parameters ({n_params * 2 / 1e9:.2f} GB), random from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    route = LMGenerateRoute(cfg, params, prompt_len=LM_PROMPT, gen_len=LM_GEN,
                            max_batch=LM_BATCH, top_k=LM_TOP_K, device=dev)
    torch.cuda.synchronize()
    planner = route.planner
    state = planner.index_state
    c, capp = state.lists.shape
    live = (state.lists >= 0).sum(dim=1)
    log(f"[lm] IVF index over the {cfg.vocab_size} unembed rows built in "
        f"{time.perf_counter() - t0:.2f} s: C={c}, capp={capp} (largest list {int(live.max())}, "
        f"mean {float(live.float().mean()):.1f}), list slab {state.list_embs.numel() * 4 / 1e9:.2f} "
        f"GB fp32, n_probe={planner.n_probe}, K={LM_TOP_K}")
    engine = ServingEngine(route, CoalescePolicy(max_batch=LM_BATCH, max_wait_s=0.002))
    t0 = time.perf_counter()
    engine.warmup()
    log(f"[lm] warmup (one batch through the path and the exact fallback) "
        f"{time.perf_counter() - t0:.2f} s; device memory {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB allocated")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (LM_PROMPT,)).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    counters = [(fk.flash_attention_fwd_cuda, "launches"), (ik.ivf_probe_topk_cuda, "launches"),
                (fr.flash_attention_ref, "calls"), (ir.ivf_probe_topk_ref, "calls")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    for p in prompts:
        engine.submit(p, arrival=0.0)
    records = engine.drain()
    counts = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
    nb = engine.batches
    check(len(records) == LM_REQUESTS, f"answered {len(records)}/{LM_REQUESTS}")
    check(fk.flash_attention_fwd_cuda.launches == cfg.num_layers * nb,
          f"K9 launched {fk.flash_attention_fwd_cuda.launches} times for {nb} prefill batches")
    check(ik.ivf_probe_topk_cuda.launches == 2 * LM_GEN * nb,
          f"ivf_topk launched {ik.ivf_probe_topk_cuda.launches} times for {nb} batches of "
          f"{LM_GEN} tokens (expected main + delta per token)")
    check(fr.flash_attention_ref.calls == 0 and ir.ivf_probe_topk_ref.calls == 0,
          f"a plain version ran on the card: {counts}")
    check(not route.degraded, "the LM route fell back to exact search")
    served = np.array([r.result for r in records])
    check(served.shape == (LM_REQUESTS, LM_GEN) and ((served >= 0) & (served < cfg.vocab_size)).all(),
          "served tokens out of range")
    lats = [r.latency for r in records]
    makespan = max(r.finish for r in records) - min(r.arrival for r in records)
    log(f"[lm] {len(records)}/{LM_REQUESTS} answered in {nb} batches (prompt {LM_PROMPT}, "
        f"{LM_GEN} generated tokens each); counts {counts}; latency p50 "
        f"{percentile(lats, 50) * 1e3:.1f} ms, p99 {percentile(lats, 99) * 1e3:.1f} ms, "
        f"{len(records) / makespan:.2f} req/s, {served.size / makespan:.1f} generated tokens/s")

    # one more pass over the batches, each stage ended by a synchronize
    stages = {"prefill": [], "retrieval": [], "decode": []}
    steps, hiddens, tokens = [], [], []

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        stages[name].append(dt)
        return out, dt

    for i in range(0, LM_REQUESTS, LM_BATCH):
        x = route.prepare(prompts[i:i + LM_BATCH])
        (hidden, cache), _ = timed("prefill", lambda: route.prefill(x))
        hs, ts = [hidden], []
        for t in range(LM_GEN):
            tok, dr = timed("retrieval", lambda: route.next_token(hidden))
            ts.append(tok)
            if t + 1 < LM_GEN:
                (hidden, cache), dd = timed("decode", lambda: lm.decode_step(
                    cfg, route.params, tok, cache, return_hidden=True))
                hs.append(hidden)
                steps.append(dr + dd)
        hiddens.append(hs)
        tokens.append(torch.stack(ts, dim=1))
        del cache
    again = torch.cat(tokens).cpu().numpy()
    med = {k: float(np.median(v)) for k, v in stages.items()}
    log(f"[lm] stages, median ms: prefill {med['prefill']:.3f} (per batch of {LM_BATCH} x "
        f"{LM_PROMPT}), retrieval {med['retrieval']:.3f} per token (ivf_topk and the greedy "
        f"head), decode {med['decode']:.3f} per token; step (retrieval + decode) p50 "
        f"{percentile(steps, 50):.3f} ms, p99 {percentile(steps, 99):.3f} ms over {len(steps)} "
        f"steps; the stage pass reproduces {int((again == served).sum())}/{served.size} served "
        "tokens")

    # where a batch's device time goes: one profiled batch
    from torch.profiler import ProfilerActivity, profile

    x = route.prepare(prompts[:LM_BATCH])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        route.run(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def device_us(ev) -> float:
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "device_time_total", 0.0)

    evs = [(device_us(e) / 1e3, e.key) for e in prof.key_averages() if device_us(e) > 0]
    busy = sum(t for t, _ in evs)
    idle = None
    if busy > 0:
        idle = 100 * (1 - busy / wall)
        flash_ms = sum(t for t, n in evs if "flash_fwd" in n)
        ivf_ms = sum(t for t, n in evs if "ivf_" in n)
        log(f"[lm] profiled batch: device busy {busy:.3f} of {wall:.3f} ms wall (profiled), idle "
            f"{idle:.1f}%; K9 {flash_ms:.3f} ms ({cfg.num_layers} launches), ivf_topk "
            f"{ivf_ms:.3f} ms ({2 * LM_GEN} launches)")
        log("[lm] top device entries (ms per batch): " + "; ".join(
            f"{n[:48]} {t:.3f}" for t, n in sorted(evs, reverse=True)[:10]))
    else:
        log("[lm] the profiler reported no device time on this machine")

    # ivf_topk at the LM shape, on the route's index and its decode queries
    sets = []
    for h in hiddens[0][:4]:
        q = h.float().contiguous()
        probe = torch.topk(q @ state.centroids.float().T, planner.n_probe, dim=1).indices
        sets.append((q, probe.to(torch.int32), state.lists, state.list_embs, LM_TOP_K))
    ivf_err = topk_err(ik.ivf_probe_topk_cuda(*sets[0]), ir.ivf_probe_topk_ref(*sets[0]),
                       "ivf_topk LM shape")
    t_k, t_p = device_ms(ik.ivf_probe_topk_cuda, sets), device_ms(ir.ivf_probe_topk_ref, sets)
    b_ms, b_by, nbytes = bound_ms(*sets[0])
    ivf_lm = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, max_abs_err=ivf_err)
    log(f"  time ivf_topk LM shape (B={LM_BATCH} L={cfg.d_model} C={c} capp={capp} "
        f"n_probe={planner.n_probe} K={LM_TOP_K}, decode queries): device ms per call (CUDA "
        f"graph) kernel {t_k:.4f}, plain {t_p:.4f}; bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.2f} MB); kernel at {100 * b_ms / t_k:.1f}% of the bound; max_abs_err "
        f"{ivf_err:.3g}")
    del sets

    # the gate: the same prompts and weights through the plain chunked
    # attention (use_flash_kernel=False), on the card
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    x = route.prepare(prompts[:LM_BATCH])
    max_len = LM_PROMPT + LM_GEN
    hp, cache_p = lm.prefill(plain_cfg, route.params, x,
                             lm.init_cache(plain_cfg, LM_BATCH, max_len, device=dev),
                             return_hidden=True)
    hk = hiddens[0][0]
    rel0 = rel_l2(hk, hp)
    check(rel0 <= LM_HIDDEN_REL, f"bf16 prefill hidden states differ: relative L2 {rel0}")
    log(f"[lm gate] bf16 prefill, kernel vs plain chunked attention: hidden states relative L2 "
        f"{rel0:.3g} (held <= {LM_HIDDEN_REL}), max abs {float((hk.float() - hp.float()).abs().max()):.3g}"
        f" of max |h| {float(hp.float().abs().max()):.3g}")
    toks_k = tokens[0]
    unembed = route.params["embed"]
    agree, rels, ties = 0, [], []
    for t in range(LM_GEN):
        if t > 0:
            hp, cache_p = lm.decode_step(plain_cfg, route.params, toks_k[:, t - 1], cache_p,
                                         return_hidden=True)
        hk = hiddens[0][t]
        rels.append(rel_l2(hk, hp))
        check(rels[-1] <= LM_HIDDEN_REL, f"step {t}: hidden states differ, relative L2 {rels[-1]}")
        tp = route.next_token(hp)
        for r in range(LM_BATCH):
            a, b = int(toks_k[r, t]), int(tp[r])
            if a == b:
                agree += 1
                continue
            slate = planner.query(hk[r:r + 1])
            top2 = torch.sort(slate.scores[0], descending=True).values[:2]
            ok, why = near_tie(hk[r], hp[r], a, b, unembed, state.centroids, planner.n_probe)
            ties.append(f"step {t} row {r}: kernel {a} / plain {b}, top-2 gap "
                        f"{float(top2[0] - top2[1]):.4g}; {why}")
            check(ok, "a token disagreement away from a near tie: " + ties[-1])
    del cache_p
    log(f"[lm gate] teacher-forced decode of the kernel path's tokens through the plain path: "
        f"hidden states relative L2 max {max(rels):.3g} over {LM_GEN} steps (held <= "
        f"{LM_HIDDEN_REL}); token agreement {agree}/{LM_BATCH * LM_GEN}"
        + "".join(f"\n[lm gate]   {s}" for s in ties))

    # one prefill batch in fp32: the same weights upcast
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = {k: (v.float() if torch.is_tensor(v) else {n: w.float() for n, w in v.items()})
                for k, v in route.params.items()}
    outs = {}
    for flash in (True, False):
        c32 = dataclasses.replace(cfg32, use_flash_kernel=flash)
        cache = lm.init_cache(c32, LM_BATCH, LM_PROMPT, device=dev)
        t0 = time.perf_counter()
        outs[flash], _ = lm.prefill(c32, params32, x, cache, return_hidden=True)
        torch.cuda.synchronize()
        log(f"[lm gate] fp32 prefill ({'kernel' if flash else 'plain'} attention) "
            f"{time.perf_counter() - t0:.2f} s")
        del cache
    e32 = close_err(outs[True], outs[False], "fp32 prefill hidden", rtol=1e-4, atol=1e-4, sums=True)
    log(f"[lm gate] fp32 prefill, kernel vs plain: hidden states within rtol 1e-4 (atol 1e-4 "
        f"max |h|): max abs {e32:.3g}, relative L2 {rel_l2(outs[True], outs[False]):.3g}")
    del params32, outs, hiddens, tokens, route, engine, params, planner, state
    torch.cuda.empty_cache()
    return dict(counts=counts, ivf_lm=ivf_lm, token_agreement=agree / (LM_BATCH * LM_GEN),
                idle=idle)


# ---------------------------------------------------------------------------
# the LM training path (Gemma-2 2B at full width)
# ---------------------------------------------------------------------------

def _dtypes(tree) -> set:
    from repro_torch.optim.optimizers import tree_leaves

    return {str(t.dtype).replace("torch.", "") for t in tree_leaves(tree)}


def lm_train_gate(cfg, batch, dev) -> dict:
    """One step each on the kernel path and on the plain chunked attention
    (use_flash_kernel=False), from the same parameters and tokens, at
    LM_GATE_LAYERS layers of the full width: step 1 in bf16, then step 2
    from the kernel path's fp32 parameters and Adam state. Losses and the
    microbatch-averaged gradients the optimizer receives are held to
    GATE_BF16 and GATE_FP32, and the dtypes to the reference's Adam."""
    import torch

    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, adam
    from repro_torch.optim.optimizers import tree_leaves

    gcfg = dataclasses.replace(cfg, num_layers=LM_GATE_LAYERS)
    opt = adam(1e-3)
    params = lm.init_params(gcfg, torch.Generator(device=dev).manual_seed(1), dev)
    state = opt.init(params)
    x, y = batch[:, :-1], batch[:, 1:]
    names = ["embed", "final_norm", *(f"layers.{n}" for n in params["layers"])]
    out = {}
    for step, (loss_tol, grad_tol) in ((1, GATE_BF16), (2, GATE_FP32)):
        res = {}
        for path, flash in (("kernel", True), ("plain", False)):
            seen = []

            def update(g, s_, p_, seen=seen):
                seen.append(g)
                return opt.update(g, s_, p_)

            train_step = lm.make_train_step(dataclasses.replace(gcfg, use_flash_kernel=flash),
                                            Optimizer(init=opt.init, update=update))
            p_new, s_new, loss = train_step(params, state, x, y)
            res[path] = (p_new, s_new, float(loss), seen[0])
        (pk, sk, lk, gk), (_, _, lp, gp) = res["kernel"], res["plain"]
        check(math.isfinite(lk) and math.isfinite(lp),
              f"gate step {step}: loss not finite ({lk}, {lp})")
        rel_loss = abs(lk - lp) / abs(lp)
        rels = [rel_l2(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gp))]
        worst = max(range(len(rels)), key=rels.__getitem__)
        grad_dtype = _dtypes(gk)
        check(rel_loss <= loss_tol, f"gate step {step}: loss {lk} vs plain {lp} "
              f"(relative {rel_loss:.3g} > {loss_tol})")
        check(max(rels) <= grad_tol, f"gate step {step}: gradient {names[worst]} relative L2 "
              f"{rels[worst]:.3g} > {grad_tol}")
        want = ({"float32"}, {"bfloat16"}) if step == 1 else ({"float32"}, {"float32"})
        got = (_dtypes(pk), _dtypes(sk["m"]) | _dtypes(sk["v"]))
        check(got == want, f"gate step {step}: params / moments dtypes {got}, expected {want}")
        log(f"[lm-train gate] step {step} ({'/'.join(sorted(grad_dtype))} gradients, "
            f"{LM_GATE_LAYERS} layers at full width, {LM_TRAIN_B} x {LM_TRAIN_S} tokens): loss "
            f"kernel {lk:.6f}, plain {lp:.6f}, relative {rel_loss:.3g} (held <= {loss_tol}); "
            f"gradients relative L2 max {rels[worst]:.3g} at {names[worst]} (held <= {grad_tol}); "
            f"params {got[0]}, moments {got[1]} after the step, as the reference's Adam")
        out[step] = dict(loss_rel=rel_loss, grad_rel=rels[worst])
        params, state = pk, sk
        del res, gk, gp
    del params, state
    torch.cuda.empty_cache()
    return out


def lm_train_phase(cfg=None, dev=None) -> dict:
    """Gemma-2 2B training at full width on the card, through K9 and K10:
    LM_TRAIN_STEPS Adam steps of a global batch of LM_TRAIN_B x LM_TRAIN_S
    tokens in microbatches of LM_TRAIN_MICRO rows, remat on; launch counts
    per step, step times, tokens/s, peak memory, one profiled step; then
    the gate against the plain chunked attention. (``cfg`` and ``dev``
    default to the full CONFIG and the card.)"""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.models import lm
    from repro_torch.optim import adam
    from repro_torch.optim.optimizers import tree_leaves

    dev = resolve_device(dev or "cuda")  # pins TF32 off
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg or get_arch("gemma2-2b").CONFIG, use_flash_kernel=True,
                              microbatch=LM_TRAIN_MICRO)
    check(cfg.remat, "the training config runs with remat")
    n_micro = LM_TRAIN_B // LM_TRAIN_MICRO
    log(f"[lm-train] device memory at the start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adam(1e-3)
    state = opt.init(params)
    train_step = lm.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[lm-train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B parameters in {cfg.dtype} (random from seed "
        f"0) and Adam(1e-3) state in {time.perf_counter() - t0:.2f} s; global batch "
        f"{LM_TRAIN_B} x {LM_TRAIN_S} tokens in {n_micro} microbatches of {LM_TRAIN_MICRO} "
        f"row(s) (strided), remat on, use_flash_kernel=True")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_TRAIN_B, LM_TRAIN_S + 1)))
               .to(dev) for _ in range(LM_TRAIN_STEPS + 1)]
    counters = [(fk.flash_attention_fwd_cuda, "launches"),
                (fk.flash_attention_bwd_cuda, "launches"),
                (fr.flash_attention_ref, "calls"), (fr.flash_attention_bwd_ref, "calls")]
    per_step = (2 * cfg.num_layers * n_micro, cfg.num_layers * n_micro)  # K9 (remat), K10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for fn, attr in counters:
        setattr(fn, attr, 0)
    for i in range(LM_TRAIN_STEPS):
        before = (fk.flash_attention_fwd_cuda.launches, fk.flash_attention_bwd_cuda.launches)
        toks = batches[i]
        t = time.perf_counter()
        params, state, loss = train_step(params, state, toks[:, :-1], toks[:, 1:])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        got = (fk.flash_attention_fwd_cuda.launches - before[0],
               fk.flash_attention_bwd_cuda.launches - before[1])
        check(got == per_step, f"step {i + 1}: K9 / K10 launched {got}, expected {per_step}")
        check(np.isfinite(losses[-1]), f"step {i + 1}: loss {losses[-1]}")
        dts = (_dtypes(params), _dtypes(state["m"]) | _dtypes(state["v"]))
        want = ({"float32"}, {"bfloat16"}) if i == 0 else ({"float32"}, {"float32"})
        check(dts == want, f"step {i + 1}: params / moments dtypes {dts}, expected {want}")
        log(f"[lm-train] step {i + 1}{' (bf16 parameters)' if i == 0 else ''}: loss "
            f"{losses[-1]:.4f}, {times[-1] * 1e3:.1f} ms; K9 {got[0]} and K10 {got[1]} "
            f"launches; params {dts[0]}, moments {dts[1]} after it")
    counts = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention_ref.calls"] == 0 and counts["flash_attention_bwd_ref.calls"] == 0,
          f"a plain version ran on the card: {counts}")
    fp32_ms = [t * 1e3 for t in times[1:]]
    p50 = percentile(fp32_ms, 50)
    tokens = LM_TRAIN_B * LM_TRAIN_S
    log(f"[lm-train] {LM_TRAIN_STEPS} steps: step 1 (bf16) {times[0] * 1e3:.1f} ms; fp32 steps "
        f"p50 {p50:.1f} ms, p99 {percentile(fp32_ms, 99):.1f} ms over {len(fp32_ms)}; "
        f"{tokens / (p50 / 1e3):.1f} tokens/s at the fp32 p50 ({tokens / times[0]:.1f} at step "
        f"1); peak device memory {peak / 1e9:.2f} GB allocated; counts {counts} "
        f"({per_step[0]} K9 and {per_step[1]} K10 launches per step)")

    # where a step's device time goes: one more step, profiled
    from torch.profiler import ProfilerActivity, profile

    toks = batches[-1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = train_step(params, state, toks[:, :-1], toks[:, 1:])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def device_us(ev) -> float:
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "device_time_total", 0.0)

    evs = [(device_us(e) / 1e3, e.key) for e in prof.key_averages() if device_us(e) > 0]
    busy = sum(t for t, _ in evs)
    idle = None
    if busy > 0:
        idle = 100 * (1 - busy / wall)
        k9 = sum(t for t, n in evs if "flash_fwd" in n)
        k10 = sum(t for t, n in evs if "flash_bwd" in n)
        log(f"[lm-train] profiled fp32 step: device busy {busy:.1f} of {wall:.1f} ms wall "
            f"(profiled), idle {idle:.1f}%; K9 {k9:.1f} ms ({per_step[0]} launches), K10 "
            f"{k10:.1f} ms ({per_step[1]} launches)")
        log("[lm-train] top device entries (ms per step): " + "; ".join(
            f"{n[:48]} {t:.1f}" for t, n in sorted(evs, reverse=True)[:10]))
    else:
        log("[lm-train] the profiler reported no device time on this machine")
    del params, state, loss, prof
    torch.cuda.empty_cache()

    gate = lm_train_gate(cfg, batches[0], dev)
    return dict(counts=counts, step1_ms=times[0] * 1e3, p50_ms=p50,
                p99_ms=percentile(fp32_ms, 99), tokens_per_s=tokens / (p50 / 1e3), peak=peak,
                idle=idle, gate=gate)


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
    from repro_torch.kernels.flash_attention import kernel as flk
    from repro_torch.kernels.fused_sampler import kernel as fk
    from repro_torch.kernels.mips_topk import kernel as mk
    from repro_torch.kernels.snis_covgrad import kernel as sk

    sources = [kernel.SOURCE, mk.SOURCE, fk.SOURCE, sk.FWD_SOURCE, sk.BWD_SOURCE, flk.SOURCE,
               flk.BWD_SOURCE]
    t0 = time.perf_counter()
    _build.build(sources)
    for lib in (kernel.library, mk.library, fk.library, sk.fwd_library, sk.bwd_library,
                flk.library, flk.bwd_library):
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
    del ds, theta0, route, planner, state, index, users, engine
    torch.cuda.empty_cache()

    # 6. flash attention (K9) against its plain version
    log("[kernels] flash_attention (K9) vs its plain version, on the card (fp32 out: rtol "
        f"{RTOL}, atol {ATOL} scaled by max |out| (sums of terms of both signs); bf16 out: rtol "
        f"2^-7 (one bf16 ulp), atol {ATOL}; lse: rtol {RTOL}, atol 1e-5)")
    with torch.inference_mode():
        fres = flash_phase()

    # 7. the flash-attention backward (K10) against its plain version
    log("[kernels] flash_attention_bwd (K10) vs its plain version, on the card, dq, dk, dv "
        f"(fp32: rtol {RTOL}, atol {ATOL} scaled by max |grad| (sums of terms of both signs); "
        f"bf16: rtol 2^-7 (one bf16 ulp), atol {ATOL} + {RTOL} max |grad|; the plain version "
        "sums the GQA group in fp32 and rounds once, as the kernel)")
    bres = flash_bwd_phase()

    # 8. the Gemma-2 2B generation path at full width, and its gate
    lres = lm_phase()

    # 9. the Gemma-2 2B training path at full width, and its gate
    tlm = lm_train_phase()

    # 10. the kernels line, the card, the result
    t = kres["timing"]["main K=10"]
    entries = [{
        "name": "ivf_topk",
        "route": "cuda",
        "source": str(kernel.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ivf_topk/kernel.py:86",
        "launches": launches + lres["counts"]["ivf_probe_topk_cuda.launches"],
        "max_abs_err": max(kres["max_abs_err"], lres["ivf_lm"]["max_abs_err"]),
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
    t = fres["timing"]["gemma prefill"]
    entries.append({
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": str(flk.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/kernel.py:104",
        "launches": (lres["counts"]["flash_attention_fwd_cuda.launches"]
                     + tlm["counts"]["flash_attention_fwd_cuda.launches"]),
        "max_abs_err": fres["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    })
    # K10's headline is the main path's shape: one 2048-token row per
    # microbatch, fp32 parameters in 5 of the 6 steps
    bt = bres["timing"]
    t, t4 = bt["main path B 1 fp32"], bt["training B 4 bf16"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    entries.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": str(flk.BWD_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/backward.py:136",
        "launches": tlm["counts"]["flash_attention_bwd_cuda.launches"],
        "max_abs_err": bres["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        # no single PyTorch call computes the attention backward alone
        "library_ms": None,
        "shape": "B 1, S 2048, H 8, KV 4, D 256, causal, cap 50, fp32 (the main path's "
                 "microbatch)",
        "main_path_b1_bf16": {k: bt["main path B 1 bf16"][k] for k in keys},
        "b4_bf16": {k: t4[k] for k in keys},
        "b4_fp32": {k: bt["training B 4 fp32"][k] for k in keys},
        "b4_bf16_fwd_bwd": {
            "flex_attention_ms": t4["library"]["ms"],
            "port_k9_k10_ms": t4["library"]["port_ms"],
            "note": "forward + backward at B 4 bf16, each eager and timed with CUDA events",
        },
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
