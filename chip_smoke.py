#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and no network,
and imports neither JAX nor the reference package. Phases, one line or
more each:

  1. environment  torch and CUDA versions, the card's name and power limit
  2. build        every hand-written kernel, from source (one nvcc per
                  source, all started together), timed; the HMMA
                  (tensor-core) instructions in the flash-attention
                  libraries' SASS (cuobjdump)
  3. kernels      each kernel against its plain PyTorch version on the
                  card, at small shapes and at the shapes its path gives
                  it (ivf_topk also at the LM route's width, L 2304, at
                  widths not a multiple of 4, at B 1 with one probe, with
                  every probed list dead and with K 256 above the live
                  candidates; mips_topk at K 10 / 64 / 256, B 1 / 33 / 64,
                  also against the emulation of its 3xTF32 arithmetic, and
                  its floor, probe and merge kernels timed apart; the covgrad
                  kernels also at L 18, 50 and 260, their wide path,
                  checked and timed; the sampler with repeated ids, id -1
                  at K > P, odd K, the largest K a block holds, eps 0 and
                  0.999, timed also at eps 1 and 0, its bound from its
                  SASS instructions a draw of each arm and a slot; the backward bitwise over
                  repeated launches and after graph replays, with its
                  ticket counters back at 0; the covgrad forward timed in
                  both modes also with one input set in L2, past L2 and
                  with every action dead, the covgrad kernels' bounds
                  over each call's distinct rows),
                  within the CPU parity tests' tolerances; times of
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
                  kernel (and shows the backward as one kernel a step). Then the first 3 steps again on the CPU through
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
  5b. maintain    fopo-paper on the maintained index: `FOPOTrainer` with
                  retriever="ivf_pallas" over the port's `build_ivf` of
                  the catalog (C 1024 by the default rule, cap from the
                  largest cluster) and `RefreshConfig()`'s defaults
                  (refresh every step, minibatch 1024, compaction every
                  64, delta_cap 64, decay 0.95), fused, fused_sampler,
                  TS 8, for 80 steps; every 8 steps `update_items`
                  re-embeds 512 catalog rows onto other rows, half from
                  the exact top-256 of 128 held users, plus noise. Gates:
                  zero staleness after every churn (each churned id the
                  delta buffers took in one live slot, a delta slot with
                  its new embedding; the rest counted in overflow); recall@64
                  of the 128 held users against exact search on the
                  current beta, right after a churn (step 56) and after
                  the compaction at step 64, within 0.02 of a fresh
                  `build_ivf` (same C and n_probe) and above the stale
                  build-time index; K7 held to its plain version (main
                  and delta pass, and the merged route against
                  `refresh_query`) with live, tombstoned and overflowed
                  delta slots; 2 K7 launches a step and no plain version;
                  then the device times of `refresh_step`, `delta_append`,
                  `compact` and `rebuild` (CUDA graphs) beside a full
                  `build_ivf`; then 3 steps replayed on the CPU with
                  injected seeds and refresh rows and one `update_items`,
                  on the card's draws, each step from the card's theta
                  and Adam state: loss, diagnostics, Adam's first
                  moment, theta (but for entries whose gradient is
                  under 1e-4 of the largest, within 2 lr) and the
                  index's state held to the card's
  5c. guard       on the same configuration, 6-step runs: two unguarded
                  runs from the same seeds agree bitwise (or the first
                  kernel whose output differs is named); a guarded run
                  that never trips equals them bitwise; NaN gradients at
                  one step skip it with theta and Adam state bitwise
                  unchanged; two in a row roll back to the snapshot;
                  recall_floor 1.01 walks compact -> rebuild -> fallback
                  and training goes on through the exact fallback
  5d. checkpoint  the maintained trainer's state (its RefreshState, the
                  generators) saved and restored bitwise at full width,
                  seconds and bytes logged; a bit-flipped latest
                  checkpoint falls back to the one before
  4b. ladder      the serving fault drill at full SASRec width: a route
                  with 64 held probe histories serves a batch,
                  `corrupt_index_state`, then 32 requests with the ladder
                  armed (probe every batch, probe_k 8, floor 1.01):
                  actions exactly compact, rebuild, fallback; every
                  request answered; the batch after the fallback equal
                  to exact search on the CPU; compact and rebuild timed
  5e. obs         fopo-paper with telemetry: 20 steps with
                  `ObsConfig(run_dir, DriftConfig())` and 20 without, from
                  the same theta, Adam state and step seeds, through the
                  `pallas` route (K6, K5, K1-K4): parameters, Adam state,
                  losses and diagnostics bitwise equal; metrics.jsonl holds
                  every record drained; trace.json the plan's spans;
                  `repro_torch.obs.report` renders the loss / ESS rows and
                  the 14 drift points; then 4 steps with
                  torch_profiler=True, whose exported trace must name K6's,
                  K5's, K2's and K4's kernels; the byte model's predicted
                  step time, the calibrated scale and step p50 with
                  telemetry on and off logged (host-bound, not gated)
  4c. cluster     SASRec cluster serving at full width: 3 `RecsysMIPSRoute`
                  replicas (each builds its own index from the same weights
                  and seed), max_batch 8, phase 4's 64 requests at qps 0.
                  Drill A, twice: a fixed service time (5 ms a batch),
                  `ReplicaFaultPlan(die=((1, 1),))`, max_failures 1: all
                  64 answered, one death, the two event traces equal, each
                  answer held to K7's plain version over the answering
                  replica's index, K7 launched on each survivor and no
                  plain version. Drill B: the card's measured service
                  times, no fault, against one engine (virtual p50 / p99,
                  req/s, the per-replica split). Then
                  `launch.serve --arch sasrec --replicas 3 --chaos
                  --obs-dir` in-process: its report has its Serving and
                  Cluster sections
  5f. dist        fopo-paper at full width on the (data, model) grid of
                  `repro_torch.dist` (fused, fused_sampler, TS 8). Drill A:
                  NCCL, a world of one in this process: 5 steps of
                  `FOPOTrainer(fopo.dist)` against the single-device trainer
                  from the same theta and step seeds (the streaming top-K on
                  both): top-K and draws equal at every step, the step-1
                  sampled scores bit for bit, losses within rtol 1e-6, theta
                  by `theta_gate`. Drill B: gloo (NCCL refuses two ranks on
                  one GPU), four ranks spawned on the one card, data 2 x
                  model 2 (slabs of 375,000 rows, 16 batch rows a data rank),
                  loading the kernels phase 2 built (they never start nvcc),
                  data and seeds through files in a temporary directory. The
                  sharded exact route, 20 steps: merged top-K equal on the
                  model ranks and, at step 1, to K6 over the whole beta
                  (`topk_err`); the step-1 sampled scores equal the
                  single-device K2's bit for bit; the single-device trainer
                  on the card replays each step's merged top-K from rank 0's
                  theta and Adam state: the same draws (K5 at row offset 16
                  for the first time on the card), losses within rtol 1e-5,
                  theta by `theta_gate`; theta equal on all ranks. The
                  maintained route (`ivf_pallas` over `build_ivf_sharded`, C
                  512 a shard, `RefreshConfig()`, 512 rows churned every 8
                  steps), 20 steps: K7 twice a step on every rank, no plain
                  version, the data replicas' index states equal, steps 1
                  and 20's merged top-K against a CPU replay of the plain K7
                  over the shards' states. The guard: NaN gradients on rank
                  3 at step 6 are skipped on every rank, theta equal. The
                  checkpoint: `save_sharded` writes beta in 4 shards,
                  `restore_sharded` gives each rank its slab of a 2-way
                  split bit for bit. Logged: each rank's step p50, the bytes,
                  calls and host ms of each collective a step (gloo through
                  the host: not NCCL's cost), times and every process's
                  peak memory. int8 gradient compression in both drills:
                  each rank `compressed_all_reduce`s a GraphCast-sized
                  gradient tree drawn from its own seed (16 leaves, 26.15 M
                  fp32 entries), then all-reduces the same tree in plain
                  fp32; every rank's result equals, on the CPU, the formula
                  from the ranks' own `quantize_int8` outputs (the int32 sum
                  exactly, the mean scale within rtol 4e-7); `STATS`' bytes,
                  calls and host ms and the wall ms of both logged
  6. embedding    the embedding-bag kernel (K8) against its plain version,
                  bit for bit: small shapes (D 1, 18, 32, 128, 130, 132,
                  264; T 1, 7, 100, 129, 300: past a round of 128 ids;
                  fp32 and bf16; sum and mean; all-padding bags beside live
                  ones, ids >= V, a table whose rows do not start on a
                  16-byte word),
                  then the DLRM shape (one table at the MLPerf DLRM-DCNv2
                  row cap, 40,000,000 x 128, in fp32 (20.48 GB), then bf16;
                  B 4096 bags of T 100, ragged (lengths 1-100) and full;
                  random ids and table from a seed), where the main path,
                  `ops.embedding_bag` sum and mean, runs with the counts set
                  to 0 just before and read just after; times of the
                  kernel, its plain version and F.embedding_bag, and the
                  byte bound over the distinct rows; also, logged only, for
                  ragged bags of Zipf-skewed ids (an illustrative skew,
                  exponent 1.05; held bit for bit, timed, not gated). The
                  tables are freed before the LM phases
  7. recsys       DIN, DIEN and Wide&Deep serving at their full CONFIG widths
                  (random weights from a seed): a `ServingEngine` with
                  max_batch 8 answers 32 requests with K 10; DIEN through
                  `RecsysMIPSRoute` (its GRU tower, then `ivf_topk` at L
                  18, launches counted, then timed), DIN and Wide&Deep through
                  `DenseCandidateRoute` over 500 candidates; the answers
                  held to the plain path on the CPU (ids as sets but for
                  boundary ties, scores within rtol 1e-5 / atol 1e-6;
                  DIEN's tower on the CPU, its retrieval on the card's user
                  vectors); latency p50 / p99 and stage times
  7b. recsys-train recsys training at the full CONFIG widths (random weights
                  from seed 0, Adam(1e-3), batches of 64 drawn as the train
                  CLI draws them): DIN, DIEN and Wide&Deep (one hashed table
                  of 4,000,000 x 32) on BCE, 10 steps each; SASRec on FOPO at
                  10^6 items (S 1000, K 256, eps 0.8, the streaming top-K at
                  block_items 8192), 20 steps, step p50 / p99; DIEN on FOPO,
                  5 steps. Each replayed on the CPU (2 BCE steps, 3 FOPO
                  steps on the card's own actions and log q), each step from
                  the card's state before it: loss within rtol 1e-5 / atol
                  1e-6, parameters by `theta_gate`, the first FOPO step's
                  top-K held to the CPU's. Peak memory and seconds logged.
                  No hand-written kernel is on this path
  7c. graphcast   GraphCast training at full width (`configs/graphcast.py:
                  CONFIG`: 16 layers, d_hidden 512, n_vars 227, sum, scan +
                  remat, fp32; random weights from seed 0), Adam(1e-3), 6
                  steps a cell: minibatch_lg (`random_graph(232,965,
                  avg_degree=GNN_DEGREE)`, its build timed; the 232,965 x 602
                  feature table and the targets on the card; each step
                  `sample_neighbors` on the host, 1024 seeds, fanout (15,
                  10), `gnn.subgraph_inputs` gathers the subgraph into the
                  cell's `gnn.static_shape`, n 169,984 / e 168,960, the
                  loss masked to the seeds),
                  full_graph_sm (2708 nodes, the first 10,556 edges of
                  `random_graph(2708, 4)`, d_feat 1433) and molecule (128
                  graphs of 30 nodes and 64 edges, d_feat 32), padded to 512.
                  Each: step p50 / p99, host sampling, peak memory, a
                  profiled step's idle share (the phase fails without one),
                  model FLOPs a second (`launch.costs`, at the padded
                  shapes and, for minibatch_lg, at the sampled subgraphs'
                  mean size) and their share of 67 TFLOP/s, the same step
                  run twice (bitwise equal, or the max |diff|). Then one
                  step at full width cut to 2 layers on full_graph_sm
                  replayed on the CPU in fp32 and fp64 (the loss within rtol
                  1e-4 of the fp64 one; each gradient leaf within 2x the
                  CPU fp32's distance from the fp64 one or within 1e-4 of
                  its largest; the Adam update by `theta_gate` within 1e-6
                  but where |g| is under the bound Adam's eps gives), and
                  `python -m
                  repro_torch.launch.train --arch graphcast --steps 3` on
                  the card. No hand-written kernel is on this path
 8. flash        the flash-attention kernel (K9) against its plain
                  version in fp32 and bf16, out and lse: small shapes
                  (ragged S, windows 8 / 64, cap 50, q_offset > 0, GQA
                  n_rep 1 and 2, every head width), the training path's
                  microbatch (B 1, H 8, KV 4, S 2048, D 256, fp32 and
                  bf16), the Gemma-2 prefill shape (B 8, same heads,
                  bf16) and S 8192 at batch 1 with window 4096; times and
                  bounds at those shapes (the bound counts each product
                  at the tensor-core passes the kernel runs), and at
                  the prefill shape torch's flex_attention, compiled, as
                  the library yardstick (in bf16 and on the fp32 upcast)
  9. flash bwd    the flash-attention backward kernel (K10) against its
                  plain version in fp32 and bf16, dq, dk and dv, with lse
                  and D from K9's plain version: small shapes (ragged S,
                  windows 8 / 64, cap 50, q_offset > 0, GQA n_rep 1 and 2,
                  every head width), the Gemma-2 training shape (B 4, H 8,
                  KV 4, S 2048, D 256; also B 1, the main path's
                  microbatch) and S 8192 at batch 1 with window 4096;
                  times and bounds, and at the training shape torch's
                  flex_attention forward + backward, compiled, as the
                  library yardstick beside K9 + K10
 10. lm           the Gemma-2 2B generation path at full width (26 layers,
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
 11. lm-train     Gemma-2 2B training at full width (26 layers, d_model
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
 11b. olmoe       OLMoE-1B-7B (16 layers, d_model 2048, 16 / 16 heads of 128,
                  64 experts of 1024 top 8, vocab 50,304, bf16; random
                  weights from seed 0): generation at full width through
                  phase 10's path (16 requests of 2048 + 16 tokens, max_batch
                  8, 16 K9 launches a prefill batch, K7 at L 2048 every
                  token), dropped_frac by layer at prefill and at decode
                  (capacity 2 a call); the gate against the plain chunked
                  attention with the routing of both recorded: a token routed
                  differently must sit at a near tie (its logit gap within
                  2 |dx| max |w_e|), a row whose compared token was rerouted
                  is set aside and counted, the rest held to phase 10's
                  tolerances, in bf16 and one prefill in fp32. Training cut
                  to 4 layers (the rest at full width, 1.9 B parameters):
                  4 Adam steps of 4 x 2048 tokens in microbatches of 1, K9
                  and K10 counted, and phase 11's gate (the (layer, expert)
                  slices a rerouted token reached set aside). Then
                  `fopo_lm_head_loss` over the final hidden states of one
                  2048-token prompt (N 2048, D 2048, S 256, K 128, eps 0.5,
                  the streaming top-K), held to the CPU on the card's draws.
                  Phases 8 and 9 also check and time K9 and K10 at OLMoE's
                  shapes (head_dim 128, a GQA group of 1, no cap, no window)
 12. the dry run (`repro_torch.launch.dryrun`) against the card: four
     cell programs as DTensors on a 1 x 1 mesh over a real NCCL group of
     one rank (GraphCast molecule, SASRec serve_p99, Gemma-2 2B
     prefill_32k --opt at global batch 1, K9 at S 32768, and train_4k
     --opt at global batch 1, K9 and K10, its layers cut to what the dry
     run says fits beside the plain run's outputs), each run on the card
     under the op walker and dry-run at the same mesh and shapes: the
     walker's FLOPs equal the dry run's, the dry run's peak lies within
     5 % + 64 MiB of max_memory_allocated, the outputs equal the plain
     step's (bitwise or within `outputs_gate`), K9 / K10 launched once a
     layer; step time against the roofline bound logged. Then three
     production cells dry-run on the 256-rank pod mesh (Gemma-2 train_4k
     baseline and --opt, SASRec train_batch), and K9's host cost a call
     through its registered operator against its ctypes wrapper
 13. step bytes  (run after 5f) one fopo-paper step at full width (P 750,000,
                  L 100, S 1000, K 256, B 32; fused, fused_sampler, TS 8)
                  on the pallas and the ivf_pallas routes (the index as
                  phase 5b builds it, n_probe 8) under the op walker
                  (`launch.jaxpr_cost.analyze`): the walker's kernel ops
                  equal the launch counters' deltas (K1-K8 are registered
                  operators) and no plain version runs; the same step on
                  meta tensors gives the same bytes, FLOPs and kernel ops
                  exactly (the rules are shape-only); each kernel op's
                  term is at least its data's bound (the same work
                  function fed the step's counts), ratios printed;
                  `jaxpr_step_bytes` beside `predict_step_bytes`, their
                  ratio held to a band a route (`STEP_BYTES_BAND`); K8
                  once through its op at the DLRM bag shape; each op's
                  host us a call (median of 1200) and device ms in a CUDA
                  graph against its ctypes wrapper, the capture running
                  the op's body; phase 5's step p50 / p99 / idle beside
 14. a JSON line of the kernels, then the card's name and power limit,
     then the last line {"ok": true, "device": {...}}

Any failed check raises, and the script exits non-zero without the last
line; it also exits non-zero when CUDA is not available.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM tf32 tensor cores, dense
RTOL, ATOL = 1e-5, 1e-6  # the CPU parity tests' score tolerances
N_PROBE, K_SERVE, MAX_BATCH, REQUESTS, RECSYS_REQUESTS = 8, 10, 8, 64, 32
TRAIN_STEPS, REPLAY_STEPS, PROFILED_STEPS, TS = 20, 3, 3, 8
# the maintained index: steps, churn cadence and rows, held users, recall@K;
# the guard drills' steps; the serving ladder's requests
MAINTAIN_STEPS, CHURN_EVERY, CHURN_ROWS, HELD_USERS, RECALL_K = 80, 8, 512, 128, 64
GUARD_STEPS, LADDER_REQUESTS = 6, 32
# telemetry: steps with and without it, then steps under torch.profiler;
# the cluster: replicas and drill A's fixed service seconds a batch
OBS_STEPS, PROF_STEPS, CLUSTER_REPLICAS, CLUSTER_SERVICE_S = 20, 4, 3, 0.005
# multiple devices: steps of drills A and B, the sharded index's clusters a
# shard, the guard drill's faulted step, the ranks' time limit
DIST_STEPS, DIST_A_STEPS, DIST_C, GUARD_AT, DIST_TIMEOUT_S = 20, 5, 512, 5, 300
LM_PROMPT, LM_GEN, LM_BATCH, LM_REQUESTS, LM_TOP_K = 2048, 16, 8, 16, 4
# recsys training (phase 7b): steps on BCE, on FOPO (SASRec, DIEN), and replayed on the CPU
RECSYS_BCE_STEPS, RECSYS_FOPO_STEPS, DIEN_FOPO_STEPS = 10, 20, 5
RECSYS_REPLAY_BCE, RECSYS_REPLAY_FOPO = 2, 3
# GraphCast training (phase 7c): steps a cell, layers of the CPU replay, the
# minibatch_lg graph's average degree (Reddit's 492, 114.6 M edges over 232,965
# nodes, cut to a third: the host build took 51.5 s at 492, 30.8 s at 246)
GNN_STEPS, GNN_REPLAY_LAYERS, GNN_DEGREE = 6, 2, 164
ADAM_EPS = 1e-8  # `repro_torch.optim.adam`'s default
BF16_RTOL = 2.0**-7  # one bf16 ulp at the bottom of a binade
LM_HIDDEN_REL = 5e-2  # bf16 prefill hidden states, kernel vs plain path (relative L2)
# LM training: global batch 4 x 2048 in microbatches of 1 row, 6 Adam steps
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_MICRO, LM_TRAIN_STEPS, LM_GATE_LAYERS = 4, 2048, 1, 6, 4
# OLMoE-1B-7B training: layers kept of 16 (the rest at full width) and Adam steps
OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_STEPS = 4, 4
# the training gate, kernel vs plain attention: (loss relative, gradient leaf relative L2)
GATE_BF16, GATE_FP32 = (1e-2, 5e-2), (1e-5, 1e-4)
# the dry run held to the card (phase 12): its peak within DRY_MEM_REL of the
# card's max_memory_allocated plus DRY_MEM_ABS bytes (cuBLAS workspaces, the
# allocator's rounding); the Gemma-2 training cell's layers chosen so that the
# dry run's peak plus its outputs fit DRY_TRAIN_FIT bytes
DRY_MEM_REL, DRY_MEM_ABS, DRY_TRAIN_FIT = 0.05, 64 << 20, 64e9


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


def device_profile(fn, calls: int = 1) -> tuple[list, float, float]:
    """One run of ``fn`` (``calls`` steps or batches) under the torch
    profiler with device activity only: each entry is a kernel, a copy or
    a fill, so their times add up to the device's busy time without
    double counts. Returns the entries with device time as (ms a call,
    name, count), the busy ms and the wall ms a call; the device's idle
    share is 1 - busy / wall. Fails if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    evs = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "device_time_total", 0.0)
        if us > 0:
            evs.append((us / 1e3 / calls, ev.key, ev.count))
    busy = sum(t for t, _, _ in evs)
    check(busy > 0, "the profiler saw no device time")
    return evs, busy, wall


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


def roof(nbytes: float, nops: float, op_rate: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time for `nbytes` moved and `nops` operations at `op_rate`
    a second (fp32 by default): (ms, "bytes" or "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / op_rate * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def ivf_live(probe, lists) -> float:
    """The live slots of every query's probed lists, summed over the queries."""
    return float((lists >= 0).sum(dim=1)[probe.long()].sum())


def bound_ms(q, probe, lists, list_embs, k) -> tuple[float, str, float]:
    """The least time for this call's work, from its data
    (`kernel.ivf_probe_work` over the live slots): each probed list's ids
    and its live slots' embeddings read once, the queries and probe ids
    read, the outputs written; 2L flops per live candidate. Returns (ms,
    "bytes" or "operations", bytes)."""
    from repro_torch.kernels.ivf_topk.kernel import ivf_probe_work

    flops, products, nbytes = ivf_probe_work(*q.shape, probe.shape[1], lists.shape[1], k,
                                             live=ivf_live(probe, lists))
    return (*roof(nbytes, flops * products), nbytes)


def kernel_phase(index, state, users) -> dict:
    """ivf_topk's kernel against its plain version at every listed shape;
    times at the serving shapes and over full lists at L 2304.
    `index`/`state` are the serving route's, `users` a list of [8, 50]
    user vectors from its tower."""
    import torch

    from repro_torch.kernels.ivf_topk import kernel, ref, tile_align_index
    from repro_torch.mips.ivf import build_ivf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    timing = {}

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

    # ragged list ends (capacity not a multiple of the kernel's 32-slot
    # ranges) and K above the candidate count
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

    # one row and one probe at DIEN's and SASRec's widths; every probed
    # list dead; K 256 above the live candidates; a list whose live rows
    # take more tiles than a block copies at once
    for tag, c, capp, l, b, n_probe, k, dead in [
        ("B 1 n_probe 1 L 18", 64, 900, 18, 1, 1, 10, 0.1),
        ("B 1 n_probe 1 L 50", 64, 900, 50, 1, 1, 10, 0.1),
        ("all probed lists dead", 16, 300, 50, 4, 4, 10, 1.0),
        ("K 256 above the live candidates", 32, 64, 50, 3, 2, 256, 0.5),
        ("a range of 1024 live rows, five tiles", 16, 1024, 50, 64, 8, 64, 0.0),
    ]:
        lists = torch.randperm(c * capp, generator=gen, device=dev).reshape(c, capp)
        lists = torch.where(torch.rand((c, capp), generator=gen, device=dev) < dead,
                            -1, lists).to(torch.int32)
        embs = torch.randn((c, capp, l), generator=gen, device=dev) * (lists >= 0)[..., None]
        q = torch.randn((b, l), generator=gen, device=dev)
        probe = torch.stack([torch.randperm(c, generator=gen, device=dev)[:n_probe]
                             for _ in range(b)]).to(torch.int32)
        compare(tag, q, probe, lists, embs.contiguous(), k)

    # the LM route's width (L 2304 = the Gemma-2 hidden, C 512, K 4, B 8,
    # n_probe 8), tiles of 4 whole rows; and widths that are not a
    # multiple of 4 (4-byte copies)
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
        if l == 2304:  # time it: 75 % of the slots live, in tiles of 4 rows
            sets = [(torch.randn((b, l), generator=gen, device=dev), torch.stack(
                [torch.randperm(c, generator=gen, device=dev)[:n_probe] for _ in range(b)]
            ).to(torch.int32), lists, embs, k) for _ in range(4)]
            t_k, t_p = (device_ms(f, sets) for f in (kernel.ivf_probe_topk_cuda,
                                                     ref.ivf_probe_topk_ref))
            b_ms, b_by, nbytes = bound_ms(*sets[0])
            log(f"  time wide L={l}: device ms per call (CUDA graph) kernel {t_k:.4f}, plain "
                f"{t_p:.4f}; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} MB); kernel "
                f"device time at {100 * b_ms / t_k:.1f}% of the bound")
            timing["full lists L=2304"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                               bound_by=b_by)
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

def stage_times(route, payloads, records, tag: str = "serve") -> None:
    """One more pass over the served batches, each stage ended by a
    synchronize: where a batch's service time goes (host and device). A
    MIPS route splits into tower and retrieval, a dense-candidate route
    has one scoring stage (the model over the pool, then its top-K)."""
    import numpy as np
    import torch

    planner = getattr(route, "planner", None)
    model = ("tower", "retrieval") if planner is not None else ("score",)
    stages = {name: [] for name in ("prepare", *model, "finalize")}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.inference_mode():
        for i in range(0, len(payloads), MAX_BATCH):
            x = timed("prepare", lambda: route.prepare(payloads[i:i + MAX_BATCH]))
            if planner is not None:
                h = timed("tower", lambda: planner.policy.user_embedding(planner.params, x))
                top = timed("retrieval", lambda: planner.plan.retrieve(
                    h, planner.beta, planner.index_state))
            else:
                top = timed("score", lambda: route.run(x))
            timed("finalize", lambda: route.finalize(top, MAX_BATCH))
    service = sorted({(r.launch, r.finish) for r in records})
    med = {k: float(np.median(v)) for k, v in stages.items()}
    log(f"[{tag}] batch service (engine) median "
        f"{float(np.median([f - s for s, f in service])) * 1e3:.3f} ms; stages, "
        "median ms over the batches: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f" (sum {sum(med.values()):.3f})")


def timed(tag: str, kernel_fn, plain_fn, sets: list, nbytes: float, nops: float,
          library_fn=None, library_note: str = "", op_rate: float = FP32_FLOPS) -> dict:
    """Device ms per call (CUDA graph) of the kernel, its plain version and
    the library call; eager ms of the first two; the bound (operations at
    `op_rate` a second)."""
    t_k, t_p = device_ms(kernel_fn, sets), device_ms(plain_fn, sets)
    e_k, e_p = time_ms(kernel_fn, sets, 50), time_ms(plain_fn, sets, 10)
    t_l = device_ms(library_fn, sets) if library_fn is not None else None
    b_ms, b_by = roof(nbytes, nops, op_rate)
    lib = f"; library {t_l:.4f} ({library_note})" if t_l is not None else ""
    log(f"  time {tag}: device ms per call (CUDA graph) kernel {t_k:.4f}, plain "
        f"{t_p:.4f}{lib}; eager ms per call kernel {e_k:.4f}, plain {e_p:.4f}; bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} Gop); "
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
    modes, and at L 18, 50 and 260); times at the training shapes."""
    import torch

    from repro_torch.constants import LOG_Q_PAD
    from repro_torch.kernels import _launch
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
    # small shapes against the plain version and against the emulation of
    # the kernel's 3xTF32 arithmetic (`ref.mips_topk_mma`), by one gate
    err = 0.0
    for bb, pp, ll, kk in [(5, 3000, 24, 64), (3, 700, 17, 10), (40, 5000, 100, 256),
                           (1, 64, 8, 64), (33, 20000, 100, 256), (64, 20000, 100, 256),
                           (1, 5000, 100, 10), (64, 3001, 17, 37), (33, 777, 7, 64)]:
        q = torch.randn((bb, ll), generator=gen, device=dev)
        it = torch.randn((pp, ll), generator=gen, device=dev)
        out = mk.mips_topk_cuda(q, it, kk)
        e = topk_err(out, mr.mips_topk_ref(q, it, kk), f"mips small b={bb} p={pp}")
        e_mma = topk_err(out, mr.mips_topk_mma(q, it, kk), f"mips small b={bb} p={pp} vs mma")
        err = max(err, e)
        log(f"  mips_topk small: B={bb} P={pp} L={ll} K={kk} max_abs_err={e:.3g}, against the "
            f"3xTF32 emulation {e_mma:.3g} ok")
    hs = [h0[i * b:(i + 1) * b].contiguous() for i in range(4)]
    for i, h in enumerate(hs[:2]):
        e = topk_err(mk.mips_topk_cuda(h, beta, k), mr.mips_topk_ref(h, beta, k),
                     f"mips full {i}")
        err = max(err, e)
        log(f"  mips_topk full: B={b} P={p} L={l} K={k} (training contexts) "
            f"max_abs_err={e:.3g} ok")
    flops, products, nbytes = mk.mips_topk_work(b, p, l, k)
    res["mips_topk"] = dict(max_abs_err=err, **timed(
        f"mips_topk B={b} P={p} K={k}", mk.mips_topk_cuda, mr.mips_topk_ref,
        [(h, beta, k) for h in hs], nbytes, flops * products,
        library_fn=lambda q, it, kk: torch.topk(q @ it.T, kk),
        library_note="torch.topk(h @ beta.T, K): two calls"))
    res["mips_topk"].update(mips_split_times(hs[0], beta, k))

    # -- fused_sampler --------------------------------------------------------
    # the largest K a block holds (its row and a membership table at most
    # half full)
    lib = fk.library()
    k_max = max(kk for kk in range(1, 40_000)
                if lib.fused_sampler_smem_bytes(kk) <= fk._MAX_SMEM)
    err, agree_min = 0.0, 1.0
    cases = []
    for bb, ss, ts, kk, pp, eps, off in [(3, 37, 8, 6, 40, 0.4, 0), (4, 100, 16, 16, 300, 0.8, 3),
                                         (2, 50, 1, 6, 40, 0.25, 5), (4, 500, 8, 37, 1000, 0.5, 0),
                                         (2, 3000, 8, 100, 100_000, 0.3, 7),
                                         (3, 300, 8, 256, p, 0.0, 0), (3, 300, 8, 256, p, 0.999, 0),
                                         (2, 200, 8, k_max, 100_000, 0.5, 0)]:
        sc = 2 * torch.randn((bb, kk), generator=gen, device=dev)
        ids = torch.stack([torch.randperm(pp, generator=gen, device=dev)[:kk]
                           for _ in range(bb)]).int()
        cases.append((f"K={kk} eps={eps}", bb, ss, ts, kk, pp, eps, off, ids, sc))
    # ids that repeat in a row; K > P with the empty slots at id -1, scored
    # as the retrieval leaves them (-3e38) and as a caller might
    ids = torch.randint(0, 12, (4, 40), generator=gen, device=dev).int()
    cases.append(("duplicate ids", 4, 300, 8, 40, 12, 0.5, 0, ids,
                  2 * torch.randn((4, 40), generator=gen, device=dev)))
    ids = torch.stack([torch.cat([torch.randperm(20, generator=gen, device=dev),
                                  torch.full((12,), -1, device=dev)]) for _ in range(3)]).int()
    sc = 2 * torch.randn((3, 32), generator=gen, device=dev)
    cases.append(("K>P, -1 ids scored", 3, 300, 8, 32, 20, 0.3, 0, ids, sc))
    cases.append(("K>P, -1 ids at -3e38", 3, 300, 8, 32, 20, 0.3, 0, ids,
                  torch.where(ids < 0, -3.0e38, sc)))
    for tag, bb, ss, ts, kk, pp, eps, off, ids, sc in cases:
        ev = torch.full((), eps, device=dev)
        kw = dict(num_samples=ss, num_items=pp, sample_tile=ts, row_offset=off)
        e, a = sampler_err(fk.fused_sampler_cuda(12345, ev, ids, sc, **kw),
                           fr.fused_sampler_ref(12345, ev, ids, sc, **kw), f"sampler {tag}")
        err, agree_min = max(err, e), min(agree_min, a)
        log(f"  fused_sampler small ({tag}): B={bb} S={ss} TS={ts} K={kk} P={pp} offset={off} "
            f"max_abs_err(log q)={e:.3g} kappa agreement {a:.6f} ok")
    try:
        fk.fused_sampler_cuda(0, ev, ids[:, :1].repeat(1, k_max + 1), sc[:, :1].repeat(1, k_max + 1),
                              num_samples=8, num_items=20, sample_tile=8)
        check(False, f"fused_sampler took K={k_max + 1}, past a block's shared memory")
    except ValueError:
        log(f"  fused_sampler: K up to {k_max} ({lib.fused_sampler_smem_bytes(k_max)} bytes of "
            f"shared memory a block), K={k_max + 1} refused")
    tops = [mk.mips_topk_cuda(h, beta, k) for h in hs]
    eps = torch.full((), 0.8, device=dev)
    kw = dict(num_samples=s, num_items=p, sample_tile=TS)
    for i, (ts_, ti_) in enumerate(tops[:2]):
        e, a = sampler_err(fk.fused_sampler_cuda(1000 + i, eps, ti_, ts_, **kw),
                           fr.fused_sampler_ref(1000 + i, eps, ti_, ts_, **kw), f"sampler full {i}")
        err, agree_min = max(err, e), min(agree_min, a)
        log(f"  fused_sampler full: B={b} S={s} TS={TS} K={k} P={p} (training top-K) "
            f"max_abs_err(log q)={e:.3g} kappa agreement {a:.6f} ok")
    # a slot can never win where it lies below the row's best by more than
    # the range of the Gumbel noise over u in [0, 1 - 2^-24], in fp32
    u = torch.tensor([0.0, 1.0 - 2.0**-24])
    g = -torch.log(-torch.log(u + 1e-12) + 1e-12)
    spread = max(float((ts_[:, 0] - ts_[:, -1]).max()) for ts_, _ in tops)
    log(f"  fused_sampler: the training top-K rows span at most {spread:.4f} in score, the "
        f"Gumbel noise {float(g[1] - g[0]):.4f}: no slot can be skipped")
    # the bound: 32-bit instructions, counted in the kernel's SASS, at the
    # card's rate for them (SMs x 128 lanes x its highest SM clock), each
    # draw charged its own arm's path, the kappa-arm draws of the timed
    # inputs their K slots
    per_slot, per_kappa, per_uniform = sampler_instructions(sass_of(fk.SOURCE))
    clock = max_sm_clock_hz()
    rate = _launch.sm_count(dev.index or 0) * 128 * clock
    sets = [(2000 + i, ti_, ts_) for i, (ts_, ti_) in enumerate(tops)]
    n_kappa = sum(int((fk.fused_sampler_cuda(sd, eps, ti_, ts_, **kw)[2] >= 0).sum())
                  for sd, ti_, ts_ in sets) / len(sets)
    nops = n_kappa * (k * per_slot + per_kappa) + (b * s - n_kappa) * per_uniform
    log(f"  fused_sampler: {n_kappa:.1f} of {b * s} draws per call on the kappa arm "
        f"({n_kappa / (b * s):.4f}), mean over the timed inputs; SASS: {per_slot:.2f} "
        f"instructions per Gumbel slot, {per_kappa} per kappa-arm and {per_uniform} per "
        f"uniform-arm draw after the last barrier (the fewest on any path through the arm); "
        f"{nops / 1e6:.2f} M instructions at {rate / 1e12:.2f} T/s ({clock / 1e6:.0f} MHz)")
    res["fused_sampler"] = dict(max_abs_err=err, kappa_agreement=agree_min,
                                instructions_per_slot=per_slot,
                                instructions_per_kappa_draw=per_kappa,
                                instructions_per_uniform_draw=per_uniform,
                                **timed(
        f"fused_sampler B={b} S={s} K={k}",
        lambda sd, ti_, ts_: fk.fused_sampler_cuda(sd, eps, ti_, ts_, **kw),
        lambda sd, ti_, ts_: fr.fused_sampler_ref(sd, eps, ti_, ts_, **kw),
        sets, fk.sampler_work(b, s, -(-s // TS) * TS, k)[2], nops, op_rate=rate))
    # what the draws' arms cost: no kappa-arm draw (eps 1: the row, the
    # table and the outputs alone), every draw on the kappa arm (eps 0)
    for e_, key in ((1.0, "ms_eps1"), (0.0, "ms_eps0")):
        ev_ = torch.full((), e_, device=dev)
        res["fused_sampler"][key] = device_ms(
            lambda sd, ti_, ts_, ev_=ev_: fk.fused_sampler_cuda(sd, ev_, ti_, ts_, **kw), sets)
    log(f"  time fused_sampler at eps 1 (no kappa-arm draw) "
        f"{res['fused_sampler']['ms_eps1']:.4f} ms, at eps 0 (every draw) "
        f"{res['fused_sampler']['ms_eps0']:.4f} ms, device ms per call (CUDA graph)")

    # -- snis_covgrad forward and backward ------------------------------------
    ferr = berr = 0.0
    # L 18, 50 (not multiples of 4) and 260 (over 256) take the wide path;
    # the rest reach every word count a lane of scores mode's register layout
    # (1-8) and lane counts that are not powers of 2 (5, 6, 10)
    for bb, ss, ll, pp in [(4, 24, 16, 300), (3, 40, 256, 500), (5, 1000, 100, 2000),
                           (4, 300, 18, 500), (4, 300, 50, 500), (3, 300, 260, 500),
                           (3, 300, 24, 500), (3, 300, 36, 500), (3, 300, 48, 500),
                           (3, 300, 64, 500), (3, 300, 96, 500), (3, 300, 112, 500),
                           (3, 300, 200, 500)]:
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
        lanes = sk.fwd_lanes(ll)
        layout = (f"a sample {lanes} lanes x {-(-ll // 4 // lanes)} words" if lanes
                  else "the wide path")
        log(f"  snis_covgrad small: B={bb} S={ss} L={ll} ({layout}) TS in (1, 8, 5), both "
            "modes, masked slots, an all-masked row, NaN coefficients on dead lanes: ok")
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
    # the backward's one launch: scheduling-independent bits, and ticket
    # counters that every launch leaves at 0, eager or replayed in a graph
    h, a, lq, r, cf = steps[0]
    g0 = sk.snis_bwd_cuda(cf, a, beta)
    check(all(torch.equal(sk.snis_bwd_cuda(cf, a, beta), g0) for _ in range(8)),
          "snis_covgrad_bwd: repeated launches differ")
    device_ms(lambda h, a, lq, r, cf: sk.snis_bwd_cuda(cf, a, beta), steps[:2], calls=4,
              replays=2)
    berr = max(berr, close_err(sk.snis_bwd_cuda(cf, a, beta), sr.snis_bwd_ref(cf, a, beta),
                               "bwd eager after graph replays", sums=True))
    torch.cuda.synchronize()
    check(all(not bool(c.any()) for c in _launch._COUNTERS.values()),
          "a launch left a ticket counter nonzero")
    log(f"  snis_covgrad_bwd: one launch a call ({sk.splits_for(b, s, _launch.sm_count(0), 2)} "
        f"(splits, chunk)); 8 repeated launches bitwise equal; an eager launch after graph "
        f"replays at B={b} matches the plain version; every ticket counter back at 0 "
        f"({len(_launch._COUNTERS)} buffers)")
    res["snis_covgrad_wide"] = covgrad_wide_times(steps, beta, gen)
    # the bounds count each call's distinct gathered rows once (a masked
    # slot reads row 0 in the forward, nothing in the backward), averaged
    # over the timed sets (`kernel.snis_fwd_work`, `snis_bwd_work`)
    fwd_rows = covgrad_rows(steps, live_only=False)
    bwd_rows = covgrad_rows(steps, live_only=True)

    def fwd_work(cg, rows):  # (bytes, operations)
        flops, products, nbytes = sk.snis_fwd_work(b, s, l, p, cg, rows=rows)
        return nbytes, flops * products

    for key, cg in (("snis_covgrad_fwd", False), ("snis_covgrad_fwd_covgrad_mode", True)):
        res[key] = timed(
            f"snis_covgrad_fwd {'covgrad mode' if cg else 'scores-only'} B={b} S={s} L={l} "
            f"(4 input sets, {fwd_rows * l * 4 / 1e6:.2f} MB of distinct rows a call)",
            lambda h, a, lq, r, cf, cg=cg: sk.snis_fwd_cuda(h, beta, a, lq, r, covgrad=cg),
            lambda h, a, lq, r, cf, cg=cg: sr.snis_fwd_ref(h, beta, a, lq, r, covgrad=cg),
            steps, *fwd_work(cg, fwd_rows))
    res["snis_covgrad_fwd"]["max_abs_err"] = ferr
    flops, products, nbytes = sk.snis_bwd_work(b, s, l, p, rows=bwd_rows)
    res["snis_covgrad_bwd"] = dict(max_abs_err=berr, **timed(
        f"snis_covgrad_bwd B={b} S={s} L={l} ({bwd_rows * l * 4 / 1e6:.2f} MB of distinct live "
        "rows a call)",
        lambda h, a, lq, r, cf: sk.snis_bwd_cuda(cf, a, beta),
        lambda h, a, lq, r, cf: sr.snis_bwd_ref(cf, a, beta),
        steps, nbytes, flops * products,
        library_fn=lambda h, a, lq, r, cf: torch.nn.functional.embedding_bag(
            a, beta, per_sample_weights=cf, mode="sum"),
        library_note="embedding_bag(actions, beta, per_sample_weights=coeff, mode='sum')"))
    # the fixed costs (every action dead: the launch, the actions, the
    # partials, the ticket; the forward reads row 0 for every slot), the
    # time with one input set's rows in the 50 MB L2, and the forward's past
    # L2 (nine sets of further training draws, over 100 MB of rows)
    dead = [(h, torch.full_like(a, -1), lq, r, cf) for h, a, lq, r, cf in steps]
    far = []
    for i in range(9):
        h = h0[(4 + i) * b:(5 + i) * b].contiguous()
        ts_, ti_ = mk.mips_topk_cuda(h, beta, k)
        a, lq, _ = fk.fused_sampler_cuda(5000 + i, eps, ti_, ts_, **kw)
        r = (torch.rand((b, s), generator=gen, device=dev) < 0.01).float()
        far.append((h, a, lq, r, steps[0][4]))
    far_rows = covgrad_rows(far, live_only=False) * l * 4 * len(far)
    check(far_rows > 100e6, f"the past-L2 sets gather only {far_rows / 1e6:.1f} MB")
    for key, cg in (("snis_covgrad_fwd", False), ("snis_covgrad_fwd_covgrad_mode", True)):
        fn = lambda h, a, lq, r, cf, cg=cg: sk.snis_fwd_cuda(h, beta, a, lq, r, covgrad=cg)
        t = res[key]
        t["ms_all_dead"] = device_ms(fn, dead)
        t["ms_l2_hot"] = device_ms(fn, steps[:1])
        t["ms_past_l2"] = device_ms(fn, far)
        t["bound_ms_all_dead"] = roof(fwd_work(cg, 1)[0], 0)[0]
        t["bound_ms_past_l2"] = roof(fwd_work(cg, far_rows / len(far) / (l * 4))[0], 0)[0]
        log(f"  time snis_covgrad_fwd {'covgrad mode' if cg else 'scores-only'}, device ms per "
            f"call (CUDA graph): 4 input sets {t['ms']:.4f} (the timing kept from the first port; bound "
            f"{t['bound_ms']:.4f}), one set in L2 {t['ms_l2_hot']:.4f}, past L2 "
            f"{t['ms_past_l2']:.4f} (9 sets, {far_rows / 1e6:.1f} MB of distinct rows; bound "
            f"{t['bound_ms_past_l2']:.4f}), every action dead {t['ms_all_dead']:.4f} (row 0 "
            f"alone; bound {t['bound_ms_all_dead']:.4f})")
    res["snis_covgrad_bwd"]["ms_all_dead"] = device_ms(
        lambda h, a, lq, r, cf: sk.snis_bwd_cuda(cf, a, beta), dead)
    res["snis_covgrad_bwd"]["ms_l2_hot"] = device_ms(
        lambda h, a, lq, r, cf: sk.snis_bwd_cuda(cf, a, beta), steps[:1])
    log(f"  time snis_covgrad_bwd with every action dead "
        f"{res['snis_covgrad_bwd']['ms_all_dead']:.4f} ms, with one input set's rows in L2 "
        f"{res['snis_covgrad_bwd']['ms_l2_hot']:.4f} ms, device ms per call (CUDA graph)")
    w = res["snis_covgrad_wide"][l]
    log(f"  snis_covgrad at L={l}, device ms, wide path / register layout: scores-only "
        f"{w['fwd']['ms']:.4f} / {res['snis_covgrad_fwd']['ms']:.4f}, covgrad mode "
        f"{w['covgrad']['ms']:.4f} / {res['snis_covgrad_fwd_covgrad_mode']['ms']:.4f}, bwd "
        f"{w['bwd']['ms']:.4f} / {res['snis_covgrad_bwd']['ms']:.4f}")
    return res


def covgrad_rows(sets, live_only: bool) -> float:
    """The beta rows one covgrad call must read, each distinct row once,
    averaged over the input sets (h, actions, ...): the forward scores a
    masked slot against row 0 (`live_only` False), the backward reads no
    row for it."""
    import torch

    n = [torch.unique(a[a >= 0] if live_only else a.clamp(min=0)).numel()
         for _, a, *_ in sets]
    return sum(n) / len(n)


def mips_split_times(h, beta, k) -> dict:
    """K6's parts timed apart at one call's inputs, each launched alone
    through the library (`which` 1, 2, 4; these launches are not the
    wrapper's and are not counted): the floor (the sample and floor
    kernels), the probe kernel (scores and the partial top-K per catalog
    chunk) and the merge kernel."""
    import torch

    from repro_torch.kernels.mips_topk import kernel as mk

    lib, args, bufs = mk._launch_args(h, beta, k)
    ms = {}
    for name, which in (("floor", 1), ("probe", 2), ("merge", 4)):
        def launch(which=which):
            err = lib.mips_topk_launch(*args, which, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"mips_topk {name} launch failed ({err})")
        ms[name] = device_ms(launch, [()])
    b, m = bufs[5].shape
    stride = args[-1]
    log(f"  mips_topk B={b} P={beta.shape[0]} K={k}, its kernels apart: device ms per call (CUDA "
        f"graph) floor {ms['floor']:.4f} ({m} rows sampled, every {stride}th), probe "
        f"{ms['probe']:.4f}, merge {ms['merge']:.4f} (chunks {args[13]} of {args[14]} rows, "
        f"{args[15]} ring stages)")
    return dict(floor_ms=ms["floor"], probe_ms=ms["probe"], merge_ms=ms["merge"])


@contextlib.contextmanager
def covgrad_wide_only():
    """The covgrad wrappers launching the wide path at every L (each
    library's `*_launch_wide` entry in place of `*_launch`), to time it
    against the register layout at an L both take."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.snis_covgrad import kernel as sk

    fl, bl = sk.fwd_library(), sk.bwd_library()
    _launch.declare(fl, "snis_fwd_launch_wide", "pppppppp" + "iiiiiii" + "p")
    _launch.declare(bl, "snis_bwd_launch_wide", "pppppp" + "iiiii" + "p")
    saved = fl.snis_fwd_launch, bl.snis_bwd_launch
    fl.snis_fwd_launch, bl.snis_bwd_launch = fl.snis_fwd_launch_wide, bl.snis_bwd_launch_wide
    try:
        yield
    finally:
        fl.snis_fwd_launch, bl.snis_bwd_launch = saved


def covgrad_wide_times(steps, beta, gen) -> dict:
    """The covgrad kernels' wide path (L 18, 50, 260) timed at the training
    draws' shape (B 32, S 1000) over a 100,000-row table of each width
    (the draws' ids taken modulo 100,000); and at L 100 on the training
    draws and table themselves, checked against the plain versions, to
    set beside the register layout's times there. Bound by bytes as at
    L 100."""
    import torch

    from repro_torch.kernels.snis_covgrad import kernel as sk, ref as sr

    res = {}
    for ll in (18, 50, 260, 100):
        if ll == beta.shape[1]:
            bt, sets, wide = beta, steps, covgrad_wide_only()
        else:
            bt = 0.3 * torch.randn((100_000, ll), generator=gen, device=steps[0][0].device)
            sets = [(torch.randn((h.shape[0], ll), generator=gen, device=h.device),
                     torch.where(a >= 0, a % 100_000, a), lq, r, cf)
                    for h, a, lq, r, cf in steps]
            wide = contextlib.nullcontext()
        b, s = sets[0][1].shape
        pp = bt.shape[0]

        def work(fn, *mode):  # (bytes, operations) with every slot live and distinct
            flops, products, nbytes = fn(b, s, ll, pp, *mode)
            return nbytes, flops * products

        with wide:
            if ll == beta.shape[1]:
                h, a, lq, r, cf = sets[0]
                sref, gref = sr.snis_fwd_ref(h, bt, a, lq, r, covgrad=True)
                sck, gk = sk.snis_fwd_cuda(h, bt, a, lq, r, covgrad=True)
                close_err(sck, sref, "wide L 100 scores", sums=True)
                close_err(gk, gref, "wide L 100 g", sums=True)
                close_err(sk.snis_fwd_cuda(h, bt, a, lq, r, covgrad=False), sref,
                          "wide L 100 scores only", sums=True)
                close_err(sk.snis_bwd_cuda(cf, a, bt), sr.snis_bwd_ref(cf, a, bt),
                          "wide L 100 bwd", sums=True)
                log(f"  snis_covgrad wide path at L={ll} (training draws), both modes and the "
                    "backward: ok")
            res[ll] = {
                "fwd": timed(f"snis_covgrad_fwd wide scores-only B={b} S={s} L={ll}",
                             lambda h, a, lq, r, cf: sk.snis_fwd_cuda(h, bt, a, lq, r,
                                                                      covgrad=False),
                             lambda h, a, lq, r, cf: sr.snis_fwd_ref(h, bt, a, lq, r,
                                                                     covgrad=False),
                             sets, *work(sk.snis_fwd_work, False)),
                "covgrad": timed(f"snis_covgrad_fwd wide covgrad mode B={b} S={s} L={ll}",
                                 lambda h, a, lq, r, cf: sk.snis_fwd_cuda(h, bt, a, lq, r,
                                                                          covgrad=True),
                                 lambda h, a, lq, r, cf: sr.snis_fwd_ref(h, bt, a, lq, r,
                                                                         covgrad=True),
                                 sets, *work(sk.snis_fwd_work, True)),
                "bwd": timed(f"snis_covgrad_bwd wide B={b} S={s} L={ll}",
                             lambda h, a, lq, r, cf: sk.snis_bwd_cuda(cf, a, bt),
                             lambda h, a, lq, r, cf: sr.snis_bwd_ref(cf, a, bt),
                             sets, *work(sk.snis_bwd_work)),
            }
        del bt, sets
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
    evs, busy, wall = device_profile(lambda: tr.train(PROFILED_STEPS), PROFILED_STEPS)
    groups = {"mips_topk": 0.0, "fused_sampler": 0.0, "snis_fwd": 0.0, "snis_bwd": 0.0,
              "other": 0.0}
    bwd_kernels = 0
    for dt, name, count in evs:
        group = ("mips_topk" if "mips_" in name else "fused_sampler" if "fused_sampler" in name
                 else "snis_fwd" if "snis_fwd" in name else "snis_bwd" if "snis_bwd" in name
                 else "other")
        groups[group] += dt
        bwd_kernels += count if group == "snis_bwd" else 0
    check(bwd_kernels == PROFILED_STEPS,
          f"the backward ran {bwd_kernels} kernels in {PROFILED_STEPS} steps, not one a step")
    log(f"[train] the backward: {bwd_kernels} kernel(s) in {PROFILED_STEPS} profiled steps")
    log(f"[train] profiled {PROFILED_STEPS} steps: device ms per step by kernel: "
        + ", ".join(f"{k} {v:.4f}" for k, v in groups.items())
        + f"; busy {busy:.4f} of {wall:.4f} ms wall per step (profiled), device idle "
        f"{100 * (1 - busy / wall):.1f}%")
    log("[train] top device entries (ms per step): "
        + "; ".join(f"{n[:48]} {t:.4f}" for t, n, _ in sorted(evs, reverse=True)[:8]))
    idle = 1 - busy / wall

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
    return dict(counts=counts, p50_ms=p50, p99_ms=p99, idle=idle,
                kappa_agreement=min(kappa_agree))


# ---------------------------------------------------------------------------
# the maintained index, the guard, checkpoints and the serving ladder
# ---------------------------------------------------------------------------

def maintained_config(health=None):
    """fopo-paper through the maintained-index route: `ivf_topk` (K7) over
    a `RefreshState` with `RefreshConfig()`'s defaults, the fused sampler
    and the fused covgrad kernels, TS 8."""
    from repro_torch.configs import get_arch
    from repro_torch.mips.refresh import RefreshConfig
    from repro_torch.train import TrainerConfig

    paper = get_arch("fopo-paper").CONFIG
    fopo = dataclasses.replace(paper.fopo, retriever="ivf_pallas", fused=True,
                               fused_sampler=True, sample_tile=TS,
                               index_refresh=RefreshConfig())
    return TrainerConfig(estimator="fopo", fopo=fopo, batch_size=paper.batch_size,
                         learning_rate=paper.learning_rate, num_steps=MAINTAIN_STEPS, seed=0,
                         health=health)


def churn_batch(beta, h_held, gen):
    """(ids, embs): CHURN_ROWS unique catalog rows re-embedded onto other
    rows' embeddings plus noise; half of the other rows are drawn from
    the exact top-256 of the held user vectors, so that churn reaches
    the lists those users probe, half from the whole catalog."""
    import torch

    p, l = beta.shape
    dev = beta.device
    ids = torch.randperm(p, generator=gen, device=dev)[:CHURN_ROWS]
    near = torch.topk(h_held @ beta.T, 256).indices.reshape(-1)
    half = CHURN_ROWS // 2
    src = torch.cat([
        near[torch.randint(0, near.numel(), (half,), generator=gen, device=dev)],
        torch.randint(0, p, (CHURN_ROWS - half,), generator=gen, device=dev),
    ])
    noise = torch.randn((CHURN_ROWS, l), generator=gen, device=dev)
    return ids.to(torch.int32), beta[src] + 0.05 * beta.std() * noise


def staleness_gate(state, overflow_before: int, ids, embs, tag: str) -> int:
    """Zero staleness right after `update_items`: each churned id the
    delta buffers took lives in exactly one live slot, a delta slot
    (`slot_of` points there) holding its new embedding bit for bit; an
    append past a full delta list is dropped and counted in `overflow`
    (its old slot stays until the next compaction, as in the reference).
    Returns the number dropped."""
    import torch

    c, cap = state.lists.shape
    dcap = state.delta_cap
    slot = state.slot_of[ids.long()].long()
    took = slot >= c * cap
    dropped = int((~took).sum())
    check(int(state.overflow) - overflow_before == dropped,
          f"{tag}: {dropped} churned ids not in a delta slot, overflow grew by "
          f"{int(state.overflow) - overflow_before}")
    dslot = slot[took] - c * cap
    check(bool(torch.equal(state.delta_lists.reshape(-1)[dslot], ids[took])),
          f"{tag}: a delta slot does not hold its id")
    check(bool(torch.equal(state.delta_embs.reshape(c * dcap, -1)[dslot], embs[took])),
          f"{tag}: a delta slot does not hold the new embedding")
    live = torch.cat([state.lists.reshape(-1), state.delta_lists.reshape(-1)])
    hits = int(torch.isin(live, ids).sum())
    check(hits == ids.numel() - int((slot < 0).sum()),
          f"{tag}: {hits} live slots hold the {ids.numel()} churned ids (a stale copy survived)")
    return dropped


def delta_kernel_gate(state, q, tag: str, k: int = 256) -> float:
    """K7 against its plain version on the maintained state: the main and
    the delta pass apart (ids as sets but for boundary ties, scores
    within RTOL / ATOL), and the merged route against `refresh_query`.
    Returns the max abs error."""
    import torch

    from repro_torch.kernels.ivf_topk import kernel as ik, ops as iops, ref as ir
    from repro_torch.mips.refresh import refresh_query

    probe = torch.topk(q @ state.centroids.T, N_PROBE, dim=1).indices.to(torch.int32)
    err = 0.0
    for name, lists, embs in (("main", state.lists, state.list_embs),
                              ("delta", state.delta_lists, state.delta_embs)):
        err = max(err, topk_err(ik.ivf_probe_topk_cuda(q, probe, lists, embs, k),
                                ir.ivf_probe_topk_ref(q, probe, lists, embs, k),
                                f"{tag} {name} pass"))
    got = iops.ivf_topk(q, state.as_index(state.slot_of.shape[0]), k, n_probe=N_PROBE,
                        delta=state.delta())
    want = refresh_query(state, q, k, N_PROBE)
    err = max(err, topk_err((got.scores, got.indices), (want.scores, want.indices),
                            f"{tag} merged vs refresh_query"))
    live = int((state.delta_lists >= 0).sum())
    filled = torch.arange(state.delta_cap, device=q.device) < state.delta_sizes[:, None]
    dead = int((filled & (state.delta_lists < 0)).sum())
    log(f"  {tag}: B={q.shape[0]} K={k} n_probe={N_PROBE}, delta slots live {live}, "
        f"tombstoned {dead}, overflow {int(state.overflow)}: main and delta pass and the "
        f"merged route held to the plain versions, max_abs_err={err:.3g} ok")
    return err


def maintained_train_phase(ds, theta0) -> dict:
    """fopo-paper at full width on the maintained index (phase 5b): 80
    steps with churn every 8, the staleness, recall and K7 gates, the
    launch counts, the maintenance ops' device times beside a full
    `build_ivf`, then a 3-step CPU replay with one `update_items`."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_sampler import kernel as fk, ref as fr
    from repro_torch.kernels.ivf_topk import kernel as ik, ops as iops, ref as ir
    from repro_torch.kernels.mips_topk import kernel as mk, ref as mr
    from repro_torch.kernels.snis_covgrad import kernel as sk, ref as sr
    from repro_torch.mips import refresh as R
    from repro_torch.mips.exact import recall_at_k, topk_exact
    from repro_torch.mips.ivf import IVFIndex, build_ivf
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train import FOPOTrainer

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = maintained_config()
    beta0 = torch.from_numpy(ds.item_embeddings).to(dev)
    p, l = beta0.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index0 = build_ivf(beta0, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    c, cap = index0.lists.shape
    log(f"[maintain] build_ivf over P={p} L={l}: C={c} (the default rule), cap={cap} (from "
        f"the largest cluster), list_embs {index0.list_embs.numel() * 4 / 1e9:.2f} GB, "
        f"built in {build_s:.2f} s")
    seeds = np.random.default_rng(23).integers(0, 2**31 - 1, MAINTAIN_STEPS + 8)
    tr = FOPOTrainer(cfg, ds, device="cuda", params=theta0,
                     step_seeds=lambda step: int(seeds[step]),
                     retriever_kwargs={"index": index0, "n_probe": N_PROBE})
    held = torch.from_numpy(ds.contexts[-HELD_USERS:]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    counters = [(mk.mips_topk_cuda, "launches"), (fk.fused_sampler_cuda, "launches"),
                (sk.snis_fwd_cuda, "launches"), (sk.snis_bwd_cuda, "launches"),
                (ik.ivf_probe_topk_cuda, "launches"), (mr.mips_topk_ref, "calls"),
                (fr.fused_sampler_ref, "calls"), (sr.snis_fwd_ref, "calls"),
                (sr.snis_bwd_ref, "calls"), (ir.ivf_probe_topk_ref, "calls")]
    counts = {f"{fn.__name__}.{attr}": 0 for fn, attr in counters}

    def held_users():
        with torch.no_grad():
            return tr.policy.user_embedding(tr.params, held).contiguous()

    def recall_gate(tag):
        h = held_users()
        exact = topk_exact(h, tr.beta, RECALL_K)
        st = tr.index_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = build_ivf(tr.beta, num_clusters=c, seed=0, device=dev)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        got = {
            "maintained": iops.ivf_topk(h, st.as_index(p), RECALL_K, n_probe=N_PROBE,
                                        delta=st.delta()),
            "fresh build_ivf": iops.ivf_topk(h, fresh, RECALL_K, n_probe=N_PROBE),
            "stale build-time index": iops.ivf_topk(h, index0, RECALL_K, n_probe=N_PROBE),
        }
        rec = {name: recall_at_k(t, exact) for name, t in got.items()}
        log(f"[maintain] {tag}: recall@{RECALL_K} over {HELD_USERS} held users against exact "
            f"search on the current beta: " + ", ".join(f"{n} {r:.4f}" for n, r in rec.items())
            + f" (fresh C={fresh.lists.shape[0]} cap={fresh.lists.shape[1]}, built in "
            f"{fresh_s:.2f} s); overflow {int(st.overflow)}, delta slots filled "
            f"{int(st.delta_sizes.sum())}")
        check(rec["maintained"] >= rec["fresh build_ivf"] - 0.02,
              f"{tag}: maintained recall {rec['maintained']} more than 0.02 below a fresh "
              f"build's {rec['fresh build_ivf']}")
        check(rec["maintained"] > rec["stale build-time index"],
              f"{tag}: maintained recall {rec['maintained']} not above the stale index's "
              f"{rec['stale build-time index']}")
        return rec

    hist = {"loss": [], "ess": [], "rbar": [], "max_wbar": [], "step_time": []}
    gates, k7_err, churned, dropped = {}, 0.0, 0, []
    for seg in range(MAINTAIN_STEPS // CHURN_EVERY):
        for fn, attr in counters:
            setattr(fn, attr, 0)
        h = tr.train(CHURN_EVERY)
        for fn, attr in counters:
            counts[f"{fn.__name__}.{attr}"] += getattr(fn, attr)
        for key in hist:
            hist[key] += h[key]
        if tr.step == cfg.fopo.index_refresh.compact_every:
            check(int(tr.index_state.delta_sizes.sum()) == 0,
                  "the compaction at step 64 left delta slots filled")
            gates["after the compaction"] = recall_gate(f"step {tr.step}, after the "
                                                        "compaction at step 64")
            k7_err = max(k7_err, delta_kernel_gate(tr.index_state, held_users(),
                                                   "K7 after the compaction"))
        if tr.step == MAINTAIN_STEPS:
            break
        ids, embs = churn_batch(tr.beta, held_users(), gen)
        overflow_before = int(tr.index_state.overflow)
        tr.update_items(ids, embs)
        churned += CHURN_ROWS
        dropped.append(staleness_gate(tr.index_state, overflow_before, ids, embs,
                                      f"churn at step {tr.step}"))
        if tr.step == 8:
            check(dropped[-1] == 0, "the first churn overflowed")
            k7_err = max(k7_err, delta_kernel_gate(tr.index_state, embs[:64].contiguous(),
                                                   "K7 live delta, the churned rows as queries"))
        if tr.step == 56:
            gates["after the churn"] = recall_gate(f"step {tr.step}, right after a churn "
                                                   f"({churned} rows churned so far)")
            state = tr.index_state
            k7_err = max(k7_err, delta_kernel_gate(state, held_users(), "K7 live delta"))
            # the same state with tombstoned delta slots (a second append of
            # churned ids) and an overflowed delta list (256 rows near one point)
            quarter = ids.numel() // 4
            tomb = R.delta_append(state, ids[:quarter], embs[quarter:2 * quarter])
            far = embs[:1] + 1e-3 * torch.randn((256, l), generator=gen, device=dev)
            over = R.delta_append(tomb, torch.arange(256, device=dev, dtype=torch.int32)
                                  + 1000, far)
            check(int(over.overflow) > int(state.overflow), "no delta list overflowed")
            k7_err = max(k7_err, delta_kernel_gate(
                over, torch.cat([held_users()[:32], far[:32]]).contiguous(),
                "K7 live, tombstoned and overflowed delta"))
            # the delta pass's time with this live buffer, at the training shape
            q = held_users()[:32].contiguous()
            probe = torch.topk(q @ state.centroids.T, N_PROBE, dim=1).indices.to(torch.int32)
            sets = [(q, probe, state.delta_lists, state.delta_embs, 256)]
            gates["k7_delta_live"] = dict(
                ms=device_ms(ik.ivf_probe_topk_cuda, sets),
                plain_ms=device_ms(ir.ivf_probe_topk_ref, sets),
                **dict(zip(("bound_ms", "bound_by", "bytes"), bound_ms(*sets[0]))))
            sets = [(q, probe, state.lists, state.list_embs, 256)]
            gates["k7_main_k256"] = dict(
                ms=device_ms(ik.ivf_probe_topk_cuda, sets),
                plain_ms=device_ms(ir.ivf_probe_topk_ref, sets),
                **dict(zip(("bound_ms", "bound_by", "bytes"), bound_ms(*sets[0]))))
            for key in ("k7_delta_live", "k7_main_k256"):
                t = gates[key]
                log(f"  time {key} (B 32, L {l}, n_probe {N_PROBE}, K 256): device ms per call "
                    f"(CUDA graph) kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}; bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes'] / 1e6:.3f} MB)")
            del tomb, over
    log(f"[maintain] {MAINTAIN_STEPS} steps, {churned} rows churned in {churned // CHURN_ROWS} "
        f"update_items, each served at once from a delta slot with its new embedding "
        f"(appends past a full delta list, dropped and counted: {dropped}); counts {counts}")
    check(counts["ivf_probe_topk_cuda.launches"] == 2 * MAINTAIN_STEPS,
          f"ivf_topk launched {counts['ivf_probe_topk_cuda.launches']} times in "
          f"{MAINTAIN_STEPS} steps (main + delta a step expected)")
    for fn in (fk.fused_sampler_cuda, sk.snis_fwd_cuda, sk.snis_bwd_cuda):
        check(counts[f"{fn.__name__}.launches"] == MAINTAIN_STEPS,
              f"{fn.__name__} launched {counts[f'{fn.__name__}.launches']} times")
    check(counts["mips_topk_cuda.launches"] == 0, "mips_topk ran on the maintained path")
    for key, n in counts.items():
        if key.endswith(".calls"):
            check(n == 0, f"the plain version {key} ran {n} times on the card")
    for key in ("loss", "ess", "rbar", "max_wbar"):
        check(bool(np.all(np.isfinite(hist[key]))), f"non-finite {key}")
    st = sorted(hist["step_time"][1:])
    p50, p99 = percentile(st, 50) * 1e3, percentile(st, 99) * 1e3
    log(f"[maintain] loss {hist['loss'][0]:+.5f} -> {hist['loss'][-1]:+.5f}; step time with "
        f"maintenance (a refresh every step, a compaction at step 64) p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms over steps 1-{MAINTAIN_STEPS - 1} (step 0 "
        f"{hist['step_time'][0] * 1e3:.3f} ms)")

    # where a maintained step's device time goes: a profiled window
    evs, busy, wall = device_profile(lambda: tr.train(PROFILED_STEPS), PROFILED_STEPS)
    groups = {"ivf_topk": 0.0, "fused_sampler": 0.0, "snis_fwd": 0.0, "snis_bwd": 0.0,
              "gemm": 0.0, "other": 0.0}
    for dt, name, _ in evs:
        group = ("ivf_topk" if "ivf_" in name else "fused_sampler" if "fused_sampler" in name
                 else "snis_fwd" if "snis_fwd" in name else "snis_bwd" if "snis_bwd" in name
                 else "gemm" if "gemm" in name.lower() or "sgemm" in name else "other")
        groups[group] += dt
    profile_ms = dict(groups, busy=busy, wall=wall)
    log(f"[maintain] profiled {PROFILED_STEPS} steps (a refresh each): device ms per step "
        + ", ".join(f"{k} {v:.4f}" for k, v in groups.items())
        + f" (gemm: the refresh's assignment and cluster sums, the tower); busy "
        f"{busy:.4f} of {wall:.4f} ms wall per step (profiled), device idle "
        f"{100 * (1 - busy / wall):.1f}%")

    # the maintenance ops' device times at P 750,000 (CUDA graphs: capture
    # also shows that none of them reads a device value on the host)
    state, beta = tr.index_state, tr.beta
    rows = torch.randint(0, p, (1024,), generator=gen, device=dev)
    ids, embs = churn_batch(beta, held_users(), gen)
    ops_ms = {
        "refresh_step": device_ms(lambda s, b, r: R.refresh_step(
            s, None, b, minibatch=1024, rows=r), [(state, beta, rows)], calls=8, replays=5),
        "delta_append": device_ms(R.delta_append, [(state, ids, embs)], calls=8, replays=5),
        "compact": device_ms(R.compact, [(state, beta)], calls=2, replays=3),
        "rebuild": device_ms(lambda s, b: R.rebuild(s, b, iters=4), [(state, beta)],
                             calls=1, replays=3),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_ivf(beta, num_clusters=c, seed=0, device=dev)
    torch.cuda.synchronize()
    ops_ms["build_ivf"] = (time.perf_counter() - t0) * 1e3
    rc = cfg.fopo.index_refresh
    cycle = (rc.compact_every * ops_ms["refresh_step"] + ops_ms["compact"]
             + rc.compact_every / CHURN_EVERY * ops_ms["delta_append"]) / rc.compact_every
    log(f"[maintain] device ms per call at P={p}, C={c}, cap={cap} (CUDA graph): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ops_ms.items() if k != "build_ivf")
        + f"; a full build_ivf (k-means++ and 12 Lloyd iterations, host clock) "
        f"{ops_ms['build_ivf']:.1f} ms; the maintenance cycle amortised over "
        f"{rc.compact_every} steps (a refresh a step, an append every {CHURN_EVERY}, one "
        f"compaction) {cycle:.4f} ms a step")

    # a 3-step CPU replay with injected seeds and refresh rows and one
    # update_items, on the card's draws; each CPU step starts from the
    # card's theta and Adam state before it (Adam turns fp32 noise in a
    # near-zero gradient entry into update differences of a few % of lr,
    # which add up over free-running steps)
    t0 = time.perf_counter()
    rrows = np.random.default_rng(37).integers(0, p, (3, cfg.fopo.index_refresh.minibatch))
    kw = dict(params=theta0, step_seeds=lambda step: int(seeds[step]),
              refresh_rows=lambda step: rrows[step])
    card_draws, cpu_draws = [], []
    a = FOPOTrainer(cfg, ds, device="cuda", retriever_kwargs={"index": index0}, **kw)
    a.plan = recording_plan(a.plan, card_draws)
    cpu_index = IVFIndex(*(t.cpu() for t in index0[:3]), index0.num_items)
    b = FOPOTrainer(cfg, ds, device="cpu", retriever_kwargs={"index": cpu_index}, **kw)
    b.plan = recording_plan(b.plan, cpu_draws, replay=card_draws)
    ids, embs = churn_batch(a.beta, held_users(), gen)
    ha, hb, after = {}, {}, {"card": [], "cpu": []}
    for name, tr_, hist_, dv in (("card", a, ha, dev), ("cpu", b, hb, torch.device("cpu"))):
        for t in range(3):
            if name == "cpu" and t > 0:
                tr_.params, tr_.opt_state = (tree_map(lambda x: x.clone(), x)
                                             for x in after["card"][t - 1])
            for key, v in tr_.train(1).items():
                if isinstance(v, list):
                    hist_.setdefault(key, []).extend(v)
            after[name].append(tuple(tree_map(lambda x: x.cpu().clone(), x)
                                     for x in (tr_.params, tr_.opt_state)))
            if t == 0:
                tr_.update_items(ids.to(dv), embs.to(dv))
    for key in ("loss", "ess", "rbar", "max_wbar"):
        close_err(torch.tensor(hb[key]), torch.tensor(ha[key]), f"maintained replay {key}")
    noisy = []
    for t in range(3):
        # the gradient through Adam's first moment m = b1 m' + (1 - b1) g,
        # both sides from the card's m' (zero before step 0)
        m_card, m_cpu = after["card"][t][1]["m"]["w"], after["cpu"][t][1]["m"]["w"]
        m_prev = after["card"][t - 1][1]["m"]["w"] if t else torch.zeros_like(m_card)
        close_err(m_cpu, m_card, f"maintained replay step {t} Adam's m", sums=True)
        noisy.append(theta_gate(after["cpu"][t][0]["w"], after["card"][t][0]["w"],
                                (m_card - 0.9 * m_prev) / 0.1, cfg.learning_rate,
                                f"maintained replay step {t} theta"))
        (ctop, _), (gtop, _) = cpu_draws[t], card_draws[t]
        topk_err((gtop.scores, gtop.indices), (ctop.scores, ctop.indices),
                 f"maintained replay step {t} top-K")
    sa, sb = a.index_state, b.index_state
    for f in ("lists", "delta_lists", "delta_sizes", "slot_of", "overflow"):
        check(bool(torch.equal(getattr(sa, f).cpu(), getattr(sb, f))),
              f"maintained replay: index {f} differs")
    close_err(sb.centroids, sa.centroids, "maintained replay centroids")
    close_err(sb.counts, sa.counts, "maintained replay counts")
    log(f"[maintain] CPU replay of 3 steps with one update_items ({time.perf_counter() - t0:.1f}"
        f" s), on the card's draws, each step from the card's theta and Adam state: loss and "
        f"diagnostics within rtol {RTOL} / atol {ATOL}, Adam's first moment within rtol "
        f"{RTOL} / atol scaled by its largest entry, theta within 1e-6 but for "
        f"{noisy} entries a step whose gradient is under 1e-4 of the largest (within 2 lr), "
        f"top-K as sets but for boundary ties at every step; after 3 free-running "
        f"maintenance steps the index's lists, delta lists, sizes, slot_of and overflow "
        f"equal, centroids and counts within rtol {RTOL} / atol {ATOL}")
    del a, b, cpu_index
    peak = torch.cuda.max_memory_allocated() / 1e9
    secs = time.perf_counter() - t_phase
    log(f"[maintain] phase took {secs:.1f} s, peak device memory {peak:.2f} GB")
    return dict(tr=tr, index0=index0, counts=counts, p50_ms=p50, p99_ms=p99, gates=gates,
                k7_err=k7_err, ops_ms=ops_ms, cycle_ms=cycle, build_s=build_s,
                seeds=seeds, seconds=secs, peak_gb=peak, profile_ms=profile_ms)


def theta_gate(got, want, grad, lr: float, tag: str, small_below: float | None = None) -> int:
    """theta after one Adam step from the same state: within 1e-6 of the
    card's but for entries whose gradient is small (|g| at most
    ``small_below``, by default 1e-4 of the largest), where Adam's g / (|g|
    + eps) turns fp32 noise in g into an update difference of a few % of
    lr; those stay within 2 lr. Returns the count of entries past 1e-6."""
    got, want, grad = got.cpu(), want.cpu(), grad.cpu()
    diff = (got - want).abs()
    off = diff > 1e-6
    if small_below is None:
        small_below = 1e-4 * float(grad.abs().max())
    small = grad.abs() <= small_below
    bad = off & ~small
    if bad.any():
        check(False, f"{tag}: differs by {float(diff[bad].max())} where the gradient is not small")
    check(float(diff.max()) <= 2 * lr, f"{tag}: differs by {float(diff.max())}")
    return int(off.sum())


def first_divergence(ra, rb, ha, hb) -> str | None:
    """Where two runs from the same seeds part: the first step whose
    top-K (K7), draws (K5) or loss and diagnostics (K1/K2) differ, else
    the backward (K3/K4) or the update. None if everything is equal."""
    import torch

    for t, ((ta, sa), (tb, sb)) in enumerate(zip(ra, rb)):
        if not (torch.equal(ta.scores, tb.scores) and torch.equal(ta.indices, tb.indices)):
            return f"step {t}: the top-K differs (ivf_topk, K7)"
        if not all(torch.equal(x, y) for x, y in zip(sa, sb)):
            return f"step {t}: the draws differ on one top-K (fused_sampler, K5)"
        if any(ha[k][t] != hb[k][t] for k in ("loss", "ess", "rbar", "max_wbar")):
            return f"step {t}: loss or diagnostics differ on one sample (snis_covgrad_fwd, K1/K2)"
    return "the parameters differ on equal losses (snis_covgrad_bwd, K3/K4, or the update)"


def guard_phase(ds, theta0, index0, seeds) -> dict:
    """The guard and the fault drills on the maintained configuration
    (phase 5c): repeatability, the guarded no-op, a NaN step skipped,
    a rollback, and the ladder walked to the exact fallback."""
    import numpy as np
    import torch

    from repro_torch.health import FaultPlan, HealthConfig, IndexHealthConfig
    from repro_torch.kernels.ivf_topk import kernel as ik
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import FOPOTrainer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    def make(health=None, fault=None, record=None):
        tr = FOPOTrainer(maintained_config(health), ds, device="cuda", params=theta0,
                         step_seeds=lambda step: int(seeds[step]), fault_plan=fault,
                         retriever_kwargs={"index": index0, "n_probe": N_PROBE})
        if record is not None:
            tr.plan = recording_plan(tr.plan, record)
        return tr

    def leaves(tr):
        return tree_leaves([tr.params, tr.opt_state, list(tr.index_state)])

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(leaves(x), leaves(y)))

    ra, rb = [], []
    a, b = make(record=ra), make(record=rb)
    ha, hb = a.train(GUARD_STEPS), b.train(GUARD_STEPS)
    repeatable = same(a, b)
    if repeatable:
        log(f"[guard] two unguarded runs of {GUARD_STEPS} steps from the same seeds: "
            "parameters, Adam state and the maintained index bitwise equal")
    else:
        where = first_divergence(ra, rb, ha, hb)
        spread = max(float((x - y).abs().max()) for x, y in zip(leaves(a), leaves(b))
                     if x.is_floating_point())
        log(f"[guard] two unguarded runs from the same seeds differ (max {spread:.3g}); "
            f"first: {where}")
    h = HealthConfig(ess_floor=1.0, grad_spike_factor=1e6, max_wbar_ceiling=0.9999)
    g = make(health=h)
    hg = g.train(GUARD_STEPS)
    check(hg["health"] == [], f"the guard tripped on a clean run: {hg['health']}")
    if repeatable:
        check(same(a, g), "the guarded run is not bitwise the unguarded one")
        check(hg["loss"] == ha["loss"], "the guarded losses differ")
        log("[guard] a guarded run that never trips (every check armed) is bitwise the "
            "unguarded one")
    else:
        check(hg["loss"][:1] == ha["loss"][:1], "the guarded first loss differs")
        gap = max(float((x - y).abs().max()) for x, y in zip(leaves(a), leaves(g))
                  if x.is_floating_point())
        check(gap <= 10 * spread, f"guarded vs unguarded {gap} beyond the runs' own {spread}")
        log(f"[guard] guarded vs unguarded differ by {gap:.3g}, within 10x the spread of two "
            "unguarded runs")

    # a NaN step is skipped: the parameters and Adam state bitwise unchanged
    n = make(health=HealthConfig(max_consecutive_bad=2, snapshot_every=1),
             fault=FaultPlan(nan_grads_at=(2,)))
    n.train(2)
    before = [t.clone() for t in tree_leaves([n.params, n.opt_state])]
    hn = n.train(1)
    check(len(hn["health"]) == 1 and "nonfinite_grads" in hn["health"][0]["checks"],
          f"the NaN step was not flagged: {hn['health']}")
    check(all(torch.equal(x, y) for x, y in zip(before, tree_leaves([n.params, n.opt_state]))),
          "the skipped step changed the parameters")
    hn = n.train(2)
    check(bool(np.all(np.isfinite(hn["loss"]))) and bool(torch.isfinite(n.params["w"]).all()),
          "training did not go on after the skip")
    # max_consecutive_bad bad steps in a row roll back to the snapshot
    r = make(health=HealthConfig(max_consecutive_bad=2, snapshot_every=1),
             fault=FaultPlan(nan_grads_at=(3, 4)))
    hr = r.train(GUARD_STEPS)
    rollbacks = [e for e in hr["events"] if e["event"] == "rollback"]
    check(len(rollbacks) == 1 and rollbacks[0]["to"] == 3 and r._restarts == 1,
          f"rollback events {hr['events']}")
    check(bool(np.isfinite(hr["loss"][-1])), "non-finite loss after the rollback")
    log(f"[guard] NaN gradients at step 2: flagged nonfinite_grads, the step "
        f"skipped with theta and Adam state bitwise unchanged; NaN at steps 3-4 with "
        f"max_consecutive_bad 2: rolled back to step {rollbacks[0]['to']} (restart #1), "
        f"{len(hr['loss'])} steps run, last loss {hr['loss'][-1]:+.5f}")

    # recall_floor 1.01: compact -> rebuild -> fallback, then on through
    # the exact fallback
    ih = IndexHealthConfig(probe_every=1, probe_rows=128, probe_k=64, recall_floor=1.01,
                           cooldown=0)
    w = make(health=HealthConfig(index=ih))
    hw = w.train(3)
    actions = [e["action"] for e in hw["index_health"] if e["action"]]
    check(actions == ["compact", "rebuild", "fallback"], f"ladder actions {actions}")
    check(w._degraded and w.plan.degraded, "the trainer did not degrade")
    before = ik.ivf_probe_topk_cuda.launches
    hw2 = w.train(3)
    check(ik.ivf_probe_topk_cuda.launches == before, "ivf_topk ran after the fallback")
    check(bool(np.all(np.isfinite(hw2["loss"]))), "non-finite loss on the exact fallback")
    log(f"[guard] recall_floor 1.01: probes {[round(e['recall'], 4) for e in hw['index_health']]}"
        f", actions {actions}; 3 more steps on the exact fallback, loss "
        f"{hw2['loss'][0]:+.5f} -> {hw2['loss'][-1]:+.5f}, no ivf_topk launch")
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[guard] phase took {secs:.1f} s, peak device memory {peak:.2f} GB")
    return dict(repeatable=repeatable, seconds=secs, peak_gb=peak)


def checkpoint_phase(tr, ds, theta0, index0) -> dict:
    """The maintained trainer's state through a checkpoint and back at
    full width, bitwise; a corrupted latest checkpoint falls back to the
    one before (phase 5d)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.health import corrupt_checkpoint
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import FOPOTrainer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr.cfg = dataclasses.replace(tr.cfg, checkpoint_dir=d)
        state0, step0 = tr._ckpt_state(), tr.step
        t0 = time.perf_counter()
        tr.save()
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(d) for f in files)
        tr.train(1)
        tr.save()
        state1 = tr._ckpt_state()

        def restored():
            r = FOPOTrainer(tr.cfg, ds, device="cuda", params=theta0,
                            retriever_kwargs={"index": index0, "n_probe": N_PROBE})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(r.maybe_restore(), "nothing restored")
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        def equal(a, b):
            la, lb = tree_leaves(a), tree_leaves(b)
            return len(la) == len(lb) and all(
                x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
                for x, y in zip(la, lb))

        r, restore_s = restored()
        check(r.step == step0 + 1 and equal(r._ckpt_state(), state1),
              "the latest checkpoint did not restore bitwise")
        corrupt_checkpoint(d, step0 + 1, mode="bitflip")
        r, _ = restored()
        check(r.step == step0 and equal(r._ckpt_state(), state0),
              "the corrupted latest checkpoint did not fall back to the one before")
        del r
    finally:
        shutil.rmtree(d, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[checkpoint] the maintained trainer's state at step {step0} (parameters, Adam "
        f"state, the RefreshState, the generators): saved in {save_s:.2f} s, {nbytes / 1e9:.3f}"
        f" GB on disk, restored in {restore_s:.2f} s, bitwise; a bit-flipped latest "
        f"checkpoint fell back to the one before, bitwise; the directory removed (phase "
        f"{secs:.1f} s, peak device memory {peak:.2f} GB)")
    return dict(save_s=save_s, restore_s=restore_s, bytes=nbytes, seconds=secs, peak_gb=peak)


def serve_ladder_phase(cfg, params) -> dict:
    """`tests/test_serve.py`'s fault drill at full SASRec width (phase 4b):
    serve, corrupt the index, serve again with the ladder armed; compact,
    rebuild, fallback in that order, every request answered, the answers
    after the fallback exact."""
    import numpy as np
    import torch

    from repro_torch.health import IndexHealthConfig, corrupt_index_state
    from repro_torch.mips.exact import TopK, topk_exact
    from repro_torch.models import recsys
    from repro_torch.serve import CoalescePolicy, RecsysMIPSRoute, ServingEngine

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(11)
    probe = rng.integers(-1, cfg.item_vocab, (64, cfg.seq_len)).astype(np.int32)
    hists = [rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
             for _ in range(LADDER_REQUESTS + MAX_BATCH)]
    route = RecsysMIPSRoute(cfg, params, k=K_SERVE, n_probe=N_PROBE, probe_hists=probe,
                            device=dev)
    planner = route.planner
    heal_ms = {}
    heal = planner.heal

    def timed_heal(action):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        heal(action)
        torch.cuda.synchronize()
        heal_ms[action] = (time.perf_counter() - t0) * 1e3

    planner.heal = timed_heal
    policy = CoalescePolicy(max_batch=MAX_BATCH, max_wait_s=0.002)
    pre = ServingEngine(route, policy)
    pre.warmup()
    for h in hists[:MAX_BATCH]:
        pre.submit(h, 0.0)
    check(len(pre.drain()) == MAX_BATCH, "the first batch was not answered")
    healthy = planner.probe()
    planner.index_state = corrupt_index_state(planner.index_state,
                                              torch.Generator(device=dev).manual_seed(1))
    broken = planner.probe()
    eng = ServingEngine(route, policy, health=IndexHealthConfig(
        probe_every=1, probe_k=8, recall_floor=1.01, cooldown=0))
    for h in hists[MAX_BATCH:]:
        eng.submit(h, 0.0)
    records = eng.drain()
    actions = [h["action"] for h in eng.monitor.history if h["action"]]
    recalls = [round(h["recall"], 4) for h in eng.monitor.history if h["recall"] is not None]
    check(actions == ["compact", "rebuild", "fallback"], f"serving ladder actions {actions}")
    check(len(records) == LADDER_REQUESTS and route.degraded,
          f"answered {len(records)}/{LADDER_REQUESTS}, degraded {route.degraded}")
    # the batches after the fallback against exact search on the CPU
    after = records[3 * MAX_BATCH:]
    x = torch.from_numpy(np.stack(hists[MAX_BATCH + 3 * MAX_BATCH:])).to(dev)
    with torch.inference_mode():
        h = recsys.sasrec_user_vector(cfg, planner.params, x)
    exact = topk_exact(h.cpu(), planner.beta.cpu(), K_SERVE)
    served = TopK(torch.from_numpy(np.stack([r.result[1] for r in after])),
                  torch.from_numpy(np.stack([r.result[0] for r in after])))
    topk_err((served.scores.cuda(), served.indices.cuda()),
             (exact.scores.cuda(), exact.indices.cuda()), "serving after the fallback")
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[ladder] SASRec at full width (10^6 items, C {planner.index_state.lists.shape[0]}): "
        f"probe recall@{planner.probe_k} healthy {healthy:.4f}, after corrupt_index_state "
        f"{broken:.4f}; the engine's probes {recalls}, actions {actions}; "
        f"{len(records)}/{LADDER_REQUESTS} answered, the {len(after)} after the fallback equal "
        f"exact search on the CPU; compact {heal_ms.get('compact', float('nan')):.1f} ms, "
        f"rebuild {heal_ms.get('rebuild', float('nan')):.1f} ms (host clock, synchronized); "
        f"phase {secs:.1f} s, peak device memory {peak:.2f} GB")
    return dict(heal_ms=heal_ms, seconds=secs, peak_gb=peak)


def obs_phase(ds, theta0) -> dict:
    """fopo-paper with telemetry (phase 5e): 20 steps with an `ObsConfig`
    (run directory, trace, drift monitor) and 20 without, from the same
    theta, Adam state and step seeds, bitwise equal; the run directory's
    JSONL stream, spans and rendered report; then 4 steps under
    `torch.profiler`, whose exported trace must name the kernels."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.fused_sampler import kernel as fk, ref as fr
    from repro_torch.kernels.mips_topk import kernel as mk, ref as mr
    from repro_torch.kernels.snis_covgrad import kernel as sk, ref as sr
    from repro_torch.obs import DriftConfig, ObsConfig
    from repro_torch.obs import report as obs_report
    from repro_torch.obs.drift import predict_step_bytes, predict_step_seconds
    from repro_torch.obs.schema import HISTORY_SCHEMA
    from repro_torch.obs.trace import PROFILE_FILE
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import FOPOTrainer, TrainerConfig

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    paper = get_arch("fopo-paper").CONFIG
    fopo = dataclasses.replace(paper.fopo, retriever="pallas", fused=True, fused_sampler=True,
                               sample_tile=TS)
    seeds = np.random.default_rng(23).integers(0, 2**31 - 1, OBS_STEPS + PROF_STEPS)

    def make(obs):
        cfg = TrainerConfig(estimator="fopo", fopo=fopo, batch_size=paper.batch_size,
                            learning_rate=paper.learning_rate, num_steps=OBS_STEPS, seed=0,
                            obs=obs)
        return FOPOTrainer(cfg, ds, device="cuda", params=theta0,
                           step_seeds=lambda step: int(seeds[step]))

    launch_fns = (mk.mips_topk_cuda, fk.fused_sampler_cuda, sk.snis_fwd_cuda, sk.snis_bwd_cuda)
    plain_fns = (mr.mips_topk_ref, fr.fused_sampler_ref, sr.snis_fwd_ref, sr.snis_bwd_ref)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        off = make(None)
        on = make(ObsConfig(run_dir=run_dir, drift=DriftConfig()))
        for fn in launch_fns:
            fn.launches = 0
        for fn in plain_fns:
            fn.calls = 0
        h_off = off.train(OBS_STEPS)
        h_on = on.train(OBS_STEPS)
        counts = {f"{fn.__name__}.launches": fn.launches for fn in launch_fns}
        for fn in launch_fns:
            check(fn.launches == 2 * OBS_STEPS,
                  f"{fn.__name__} launched {fn.launches} times in 2 x {OBS_STEPS} steps")
        for fn in plain_fns:
            check(fn.calls == 0, f"the plain version {fn.__name__} ran {fn.calls} times")
        leaves_off = tree_leaves([off.params, off.opt_state])
        leaves_on = tree_leaves([on.params, on.opt_state])
        equal = len(leaves_off) == len(leaves_on) and all(
            torch.equal(a, b) for a, b in zip(leaves_off, leaves_on))
        diverged = next((t for t in range(OBS_STEPS) if any(
            h_off[k][t] != h_on[k][t] for k in ("loss", "ess", "rbar", "max_wbar"))), None)
        check(equal and diverged is None,
              f"telemetry changed the run: parameters / Adam state equal {equal}, first "
              f"step whose loss or diagnostics differ {diverged}")
        # the JSONL stream holds every record drained: the history's lists
        lines = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
        drained = sum(len(h_on[k]) for k, (kind, _) in HISTORY_SCHEMA.items()
                      if kind != "scalar")
        check(len(lines) == drained, f"metrics.jsonl holds {len(lines)} of {drained} records")
        per_name = {n: sum(r["name"] == n for r in lines)
                    for n in ("loss", "step_time", "ess", "rbar", "max_wbar", "drift")}
        drift_n = OBS_STEPS - 1 - DriftConfig().calibration_steps
        check(all(per_name[n] == OBS_STEPS for n in ("loss", "step_time", "ess", "rbar",
                                                      "max_wbar")),
              f"metrics.jsonl records by name {per_name}")
        check(per_name["drift"] == len(h_on["drift"]) == drift_n,
              f"drift points {per_name['drift']} / {len(h_on['drift'])}, expected {drift_n}")
        spans = json.load(open(os.path.join(run_dir, "trace.json")))["traceEvents"]
        names = {e["name"] for e in spans}
        want = {"dispatch", "drain", "user_embedding", "retrieval", "sample", "reward",
                "surrogate"}
        check(want <= names, f"trace.json lacks spans {sorted(want - names)}")
        obs_report.main([run_dir])
        text = open(os.path.join(run_dir, "report.md")).read()
        csv = text.split("point,drift_ratio\n", 1)[-1].split("```", 1)[0].splitlines()
        check(f"| loss | {OBS_STEPS} |" in text and f"| ess | {OBS_STEPS} |" in text
              and "## Roofline drift" in text and len(csv) == drift_n,
              "the rendered report lacks the loss / ESS rows or the drift series")

        # the profiler: 4 more steps, its trace must name the kernels
        prof_dir = os.path.join(run_dir, "profiled")
        on.cfg = dataclasses.replace(on.cfg, obs=ObsConfig(run_dir=prof_dir, drift=None,
                                                           torch_profiler=True))
        on.train(PROF_STEPS)
        path = os.path.join(prof_dir, "torchprof", PROFILE_FILE)
        check(os.path.exists(path), "torch.profiler did not start or export its trace")
        events = json.load(open(path))["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        symbols = {"K6": ("mips_probe_kernel", "mips_merge_kernel"),
                   "K5": ("fused_sampler_kernel",), "K2": ("snis_fwd_scores",),
                   "K4": ("snis_bwd_kernel",)}
        found = {s: sum(s in k for k in kernels) for syms in symbols.values() for s in syms}
        check(all(found.values()), f"the profiler's trace lacks kernels: {found} "
              f"({len(kernels)} kernel events, categories "
              f"{sorted({str(e.get('cat')) for e in events})})")
        prof_mb = os.path.getsize(path) / 1e6
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    pred = predict_step_bytes(on.plan, paper.batch_size, paper.embed_dim)
    pred_s = predict_step_seconds(on.plan, paper.batch_size, paper.embed_dim)
    st_on, st_off = h_on["step_time"], h_off["step_time"]
    p50_on, p50_off = percentile(st_on[1:], 50) * 1e3, percentile(st_off[1:], 50) * 1e3
    scale = float(np.median(st_on[1:1 + DriftConfig().calibration_steps])) / pred_s
    # train()'s wall time a step after step 0, the drains, the JSONL writes
    # and trace.json included: what telemetry adds on the host outside step_time
    wall_on, wall_off = ((h["total_time"] - h["step_time"][0]) / (OBS_STEPS - 1) * 1e3
                         for h in (h_on, h_off))
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[obs] fopo-paper (pallas, fused, fused_sampler, TS {TS}): {OBS_STEPS} steps with "
        f"ObsConfig(run_dir, DriftConfig()) and {OBS_STEPS} without, from the same theta, "
        f"Adam state and seeds: parameters, Adam state, losses and diagnostics bitwise "
        f"equal; launches {counts}, no plain version; metrics.jsonl {len(lines)} records "
        f"(every record drained: {per_name}); trace.json {len(spans)} spans ({sorted(want)} "
        f"present); report.md rendered with the loss / ESS rows and {drift_n} drift points")
    log(f"[obs] the byte model: {pred['total_bytes'] / 1e6:.1f} MB a step (snis "
        f"{pred['snis_bytes'] / 1e6:.2f}, sampler {pred['sampler_bytes'] / 1e6:.2f}, "
        f"retrieval {pred['retrieval_bytes'] / 1e6:.2f}) = {pred_s * 1e3:.4f} ms at 3.35 TB/s; "
        f"measured step p50 {p50_on:.3f} ms with telemetry, {p50_off:.3f} without (steps "
        f"1-{OBS_STEPS - 1}; host clock, synchronized); train()'s wall time a step (after "
        f"step 0) {wall_on:.3f} ms "
        f"with telemetry, {wall_off:.3f} without; calibrated scale {scale:.1f}; "
        f"drift EMA last {h_on['drift'][-1]:.3f}, {len(h_on['drift_events'])} excursion "
        f"warning(s)")
    log(f"[obs] torch.profiler over {PROF_STEPS} steps: {len(kernels)} kernel events in a "
        f"{prof_mb:.1f} MB Chrome trace, by symbol {found}")
    log(f"[obs] phase took {secs:.1f} s, peak device memory {peak:.2f} GB")
    return dict(counts=counts, p50_on_ms=p50_on, p50_off_ms=p50_off, wall_on_ms=wall_on,
                wall_off_ms=wall_off, predicted_ms=pred_s * 1e3, scale=scale, seconds=secs,
                peak_gb=peak)


def cluster_phase(cfg, params, payloads) -> dict:
    """SASRec cluster serving at full width (phase 4c): 3 replicas, each
    building its own index from the same weights and seed. Drill A, run
    twice: a fixed service time, replica 1 dies at its first dispatch;
    every request answered, one death, equal event traces, each answer
    held to K7's plain version over the answering replica's index, K7
    launched on each survivor and no plain version. Drill B: the card's
    own service times, no fault, against one engine. Then the serving CLI
    with ``--replicas 3 --chaos --obs-dir``."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.health import ReplicaFaultPlan
    from repro_torch.kernels.ivf_topk import kernel as ik, ops, ref as ir
    from repro_torch.launch import serve as serve_cli
    from repro_torch.mips.refresh import RefreshState
    from repro_torch.models import recsys
    from repro_torch.obs.report import render_run
    from repro_torch.serve import (
        CoalescePolicy,
        Dispatcher,
        DispatchPolicy,
        RecsysMIPSRoute,
        ServingEngine,
    )

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    routes = [RecsysMIPSRoute(cfg, params, k=K_SERVE, n_probe=N_PROBE, device=dev)
              for _ in range(CLUSTER_REPLICAS)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    coalesce = CoalescePolicy(max_batch=MAX_BATCH, max_wait_s=0.002)

    # drill A, twice: a fixed service time, replica 1 dies at its first dispatch
    traces, first = [], None
    for _ in range(2):
        disp = Dispatcher(routes, coalesce, DispatchPolicy(max_failures=1),
                          fault_plan=ReplicaFaultPlan(die=((1, 1),)),
                          service_model=lambda measured, batch_no: CLUSTER_SERVICE_S)
        disp.warmup()
        ik.ivf_probe_topk_cuda.launches = 0
        ir.ivf_probe_topk_ref.calls = 0
        for p in payloads:
            disp.submit(p, 0.0)
        res = disp.drain()
        launches, plain = ik.ivf_probe_topk_cuda.launches, ir.ivf_probe_topk_ref.calls
        split = disp.per_replica()
        survivors = [r for r in split if r["alive"]]
        check(len(res) == len(payloads) and not res.unanswered,
              f"drill A answered {len(res)}/{len(payloads)}, {len(res.unanswered)} unanswered")
        check(disp.bus.total("serve_replica_deaths") == 1 and not disp.replicas[1].alive,
              f"deaths {disp.bus.total('serve_replica_deaths')}")
        check(len(survivors) == CLUSTER_REPLICAS - 1 and all(r["batches"] > 0 for r in survivors),
              f"a survivor served nothing: {split}")
        check(launches == 2 * sum(r["batches"] for r in survivors),
              f"ivf_topk launched {launches} times for {[r['batches'] for r in survivors]} "
              "batches on the survivors (expected main + delta a batch)")
        check(plain == 0, f"the plain version ran {plain} times on the card")
        traces.append(disp.event_trace())
        if first is None:
            first = (disp, res, launches, split)
    check(traces[0] == traces[1], "the two drills' event traces differ")
    disp, res, launches_a, split_a = first
    # each answer against K7's plain version over the answering replica's index
    with torch.inference_mode():
        h = recsys.sasrec_user_vector(
            cfg, routes[0].planner.params, torch.from_numpy(np.stack(payloads)).to(dev))
    err = 0.0
    for rep in sorted({r.replica for r in res}):
        recs = [r for r in res if r.replica == rep]
        planner = routes[rep].planner
        st = RefreshState(*(t.cpu() for t in planner.index_state))
        exp = ops.ivf_topk(h[[r.rid for r in recs]].cpu(), st.as_index(cfg.item_vocab),
                           K_SERVE, n_probe=planner.n_probe, delta=st.delta())
        served = (torch.from_numpy(np.stack([r.result[1] for r in recs])).to(dev),
                  torch.from_numpy(np.stack([r.result[0] for r in recs])).to(dev))
        err = max(err, topk_err(served, (exp.scores.to(dev), exp.indices.to(dev)),
                                f"cluster drill A replica {rep}"))
    kinds = {}
    for e in traces[0]:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    lats_a = disp.latencies()
    log(f"[cluster] SASRec at full width, {CLUSTER_REPLICAS} replicas (each built its own "
        f"index: {build_s:.2f} s for the {CLUSTER_REPLICAS}), max_batch {MAX_BATCH}, "
        f"{len(payloads)} requests at qps 0")
    log(f"[cluster] drill A (service {CLUSTER_SERVICE_S * 1e3:g} ms a batch, replica 1 dies "
        f"at its first dispatch, max_failures 1), twice: {len(res)}/{len(payloads)} answered, "
        f"0 unanswered, deaths 1, retries {disp.bus.total('serve_retries'):g}, events "
        f"{kinds}, the two event traces equal ({len(traces[0])} events); load "
        f"{[(r['replica'], r['batches'], r['requests'], r['alive']) for r in split_a]}; "
        f"ivf_topk launches {launches_a} (main + delta a batch on the survivors), plain-version "
        f"calls 0; answers held to K7's plain version on the CPU over the answering "
        f"replica's index (max |score diff| {err:.3g}); virtual p50 "
        f"{percentile(lats_a, 50) * 1e3:.3f} ms, p99 {percentile(lats_a, 99) * 1e3:.3f} ms")

    # drill B: the card's own service times, no fault, against one engine
    single = ServingEngine(routes[0], coalesce)
    single.warmup()
    disp_b = Dispatcher(routes, coalesce, DispatchPolicy())
    disp_b.warmup()
    ik.ivf_probe_topk_cuda.launches = 0
    ir.ivf_probe_topk_ref.calls = 0
    for p in payloads:
        single.submit(p, 0.0)
    one = single.drain()
    for p in payloads:
        disp_b.submit(p, 0.0)
    res_b = disp_b.drain()
    launches_b = ik.ivf_probe_topk_cuda.launches
    check(len(one) == len(res_b) == len(payloads) and not res_b.unanswered,
          f"drill B answered {len(one)} (one engine) and {len(res_b)} (cluster)")
    batches_b = single.batches + sum(r["batches"] for r in disp_b.per_replica())
    check(launches_b == 2 * batches_b and ir.ivf_probe_topk_ref.calls == 0,
          f"drill B: ivf_topk launched {launches_b} times for {batches_b} batches, plain "
          f"version {ir.ivf_probe_topk_ref.calls} calls")
    out = {}
    for tag, recs in (("one engine", one), ("cluster", res_b)):
        lats = [r.latency for r in recs]
        span_s = max(r.finish for r in recs) - min(r.arrival for r in recs)
        out[tag] = dict(p50_ms=percentile(lats, 50) * 1e3, p99_ms=percentile(lats, 99) * 1e3,
                        req_s=len(recs) / span_s, makespan_ms=span_s * 1e3)
    log(f"[cluster] drill B (the card's measured service times, no fault): one engine "
        f"p50 {out['one engine']['p50_ms']:.3f} ms, p99 {out['one engine']['p99_ms']:.3f}, "
        f"{out['one engine']['req_s']:.1f} req/s (makespan "
        f"{out['one engine']['makespan_ms']:.3f} ms) in {single.batches} batches; "
        f"{CLUSTER_REPLICAS} replicas p50 {out['cluster']['p50_ms']:.3f} ms, p99 "
        f"{out['cluster']['p99_ms']:.3f}, {out['cluster']['req_s']:.1f} req/s (makespan "
        f"{out['cluster']['makespan_ms']:.3f} ms); per replica "
        f"{[(r['replica'], r['batches'], r['requests']) for r in disp_b.per_replica()]} "
        f"(virtual clocks: the replicas' batches ran one after another on this card)")

    # the CLI: --replicas 3 --chaos --obs-dir, in-process
    d = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        serve_cli.main(["--arch", "sasrec", "--replicas", str(CLUSTER_REPLICAS), "--chaos",
                        "--obs-dir", d])
        text = open(render_run(d)).read()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check("## Serving" in text and "## Cluster" in text,
          "the CLI run's report lacks its Serving or Cluster section")
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[cluster] launch.serve --arch sasrec --replicas {CLUSTER_REPLICAS} --chaos "
        f"--obs-dir: every request answered, the report has its Serving and Cluster "
        f"sections; phase {secs:.1f} s, peak device memory {peak:.2f} GB")
    return dict(launches=launches_a + launches_b, max_abs_err=err, drill_b=out, seconds=secs,
                peak_gb=peak)


# ---------------------------------------------------------------------------
# embedding_bag (K8): kernel vs plain version, and its path at a DLRM shape
# ---------------------------------------------------------------------------

def eb_counts(table, idx) -> tuple[int, int]:
    """(distinct live rows, live ids) of these bags; an id >= V reads row V - 1."""
    import torch

    live = idx[idx >= 0].clamp(max=table.shape[0] - 1)
    return torch.unique(live).numel(), live.numel()


def eb_bound(table, idx) -> tuple[float, str, float]:
    """The least time for one sum over these bags (`kernel.embedding_bag_work`
    over this call's counts): each distinct live row read once, the ids
    read, the output written; one add per element of a live row. (ms,
    "bytes" or "operations", bytes)."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_work

    rows, live = eb_counts(table, idx)
    flops, products, nbytes = embedding_bag_work(*idx.shape, *table.shape,
                                                 table.element_size(), rows=rows, live=live)
    return (*roof(nbytes, flops * products), nbytes)


def eb_mean_plain(table, idx):
    """The mean as `ops.embedding_bag` takes it, on the plain version."""
    import torch

    from repro_torch.kernels.embedding_bag import ref

    counts = (idx >= 0).to(table.dtype).sum(dim=1, keepdim=True)
    return ref.embedding_bag_ref(table, idx) / torch.clamp(counts, min=1e-9)


def eb_same(got, want, tag: str) -> float:
    """Bit for bit (the kernel adds in t order in the table's dtype, as its
    plain version); returns the max |difference| (0)."""
    import torch

    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape, f"{tag}: dtype/shape")
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite output")
    diff = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, want), f"{tag}: differs from the plain version, max {diff}")
    return diff


def dlrm_bags(b: int, t: int, v: int, gen, full: bool):
    """[B, T] int32 bags over V rows, uniform ids: full (every slot live)
    or ragged (lengths uniform in 1..T, the rest -1)."""
    import torch

    dev = gen.device
    idx = torch.randint(0, v, (b, t), generator=gen, device=dev, dtype=torch.int32)
    if full:
        return idx
    lens = torch.randint(1, t + 1, (b, 1), generator=gen, device=dev)
    return torch.where(torch.arange(t, device=dev)[None, :] < lens, idx, -1)


def zipf_bags(b: int, t: int, v: int, gen, alpha: float = 1.05):
    """[B, T] int32 ragged bags (lengths uniform in 1..T, the rest -1)
    with an illustrative skew of ids: the rank of an id is Zipf-distributed
    with exponent `alpha` over V ranks (inverse CDF of the continuous power
    law), and rank r is row r * 2654435761 mod V, so the hot rows lie
    scattered over the table. The exponent is not taken from a measurement
    of a real feature's ids: these times show how K8 behaves when rows
    repeat, not what a production ranker would see."""
    import torch

    dev = gen.device
    u = torch.rand((b, t), generator=gen, device=dev, dtype=torch.float64)
    x = 1.0 + u * (v ** (1.0 - alpha) - 1.0)
    rank = (x ** (1.0 / (1.0 - alpha))).long().clamp(1, v) - 1
    idx = (rank * 2654435761 % v).int()
    lens = torch.randint(1, t + 1, (b, 1), generator=gen, device=dev)
    return torch.where(torch.arange(t, device=dev)[None, :] < lens, idx, -1)


def eb_library_args(table, idx) -> tuple:
    """(the live ids, flat in bag order, their bags' offsets, table): the
    library call's inputs for the same bags."""
    import torch

    live = idx >= 0
    counts = live.sum(dim=1)
    return idx[live], torch.cumsum(counts, 0) - counts, table


def eb_library(flat, offsets, table):
    """`torch.nn.functional.embedding_bag` in sum mode over the live ids
    with offsets: one PyTorch call computing the same sum (in its own
    order; in bf16 it rounds once, the kernel after every add)."""
    import torch.nn.functional as F

    return F.embedding_bag(flat, table, offsets, mode="sum")


def embedding_bag_phase() -> dict:
    """K8 against its plain version: small shapes (D 1, 18, 32, 128, 130,
    132, 264; T 1, 7, 100, 129, 300; all-padding bags, ids >= V; a
    misaligned table), then the DLRM shape
    (40,000,000 x 128, B 4096, T 100, ragged and full bags) in fp32, then
    bf16; the main path (`ops.embedding_bag`, sum and mean) driven there
    with the counts set to 0 just before and read just after; times of the
    kernel, its plain version and F.embedding_bag, and the bound, also
    for ragged bags of Zipf-skewed ids (an illustrative skew, not on the
    main path; logged, not in the kernels line). The tables are freed at
    the end."""
    import torch

    from repro_torch.kernels.embedding_bag import kernel, ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    torch.cuda.reset_peak_memory_stats()
    max_err = 0.0
    n_small = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 18, 32, 128, 130, 132, 264):
            table = (torch.randn((1000, d), generator=gen, device=dev) * 10).to(dtype)
            for t in (1, 7, 100, 129, 300):
                idx = torch.randint(-1, 1000, (37, t), generator=gen, device=dev,
                                    dtype=torch.int32)
                idx[torch.rand((37, t), generator=gen, device=dev) < 0.3] = -1
                idx[0] = -1  # an all-padding bag: 0
                idx[5:8] = -1  # all-padding bags beside live ones in one block
                idx[1:5, 0] = 1000 + torch.arange(4, device=dev, dtype=torch.int32)  # >= V
                idx[8] = torch.randint(0, 1000, (t,), generator=gen, device=dev,
                                       dtype=torch.int32)  # every id live
                out = ops.embedding_bag(table, idx, "sum")
                max_err = max(max_err, eb_same(out, ref.embedding_bag_ref(table, idx),
                                               f"D={d} T={t} {dtype} sum"))
                check(not bool(out[[0, 5, 6, 7]].any()),
                      f"D={d} T={t}: an all-padding bag is not 0")
                eb_same(ops.embedding_bag(table, idx, "mean"), eb_mean_plain(table, idx),
                        f"D={d} T={t} {dtype} mean")
                n_small += 2
        # a table whose rows do not start on a word: the scalar path at D 128
        buf = torch.randn((1000 * 128 + 1,), generator=gen, device=dev).to(dtype)
        table = buf[1:].view(1000, 128)
        idx = torch.randint(-1, 1000, (37, 300), generator=gen, device=dev, dtype=torch.int32)
        check(kernel.vec_width(table) == 1, "the misaligned table took the word path")
        eb_same(ops.embedding_bag(table, idx), ref.embedding_bag_ref(table, idx),
                f"misaligned {dtype}")
        n_small += 1
    log(f"  small shapes: {n_small} cases (D 1 / 18 / 32 / 128 / 130 / 132 / 264, T 1 / 7 / "
        "100 / 129 / 300 (past a round of 128 ids, and bags of many register batches), fp32 "
        "and bf16, sum and mean, all-padding bags beside live ones in a block, bags with "
        "every id live, ids >= V, a misaligned table): bit for bit")

    # the DLRM shape: one table at the MLPerf DLRM-DCNv2 row cap, B 4096
    v, d, b, t = 40_000_000, 128, 4096, 100
    launches = plain_calls = 0
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        t0 = time.perf_counter()
        table = torch.randn((v, d), generator=gen, device=dev, dtype=dtype)
        sets = {kind: [dlrm_bags(b, t, v, gen, full=kind == "full") for _ in range(3)]
                for kind in ("ragged", "full")}
        sets["skewed"] = [zipf_bags(b, t, v, gen) for _ in range(3)]
        torch.cuda.synchronize()
        log(f"  DLRM table {v} x {d} {name} ({table.numel() * table.element_size() / 1e9:.2f} "
            f"GB) made in {time.perf_counter() - t0:.2f} s")
        # the main path, counts set to 0 just before and read just after
        kernel.embedding_bag_cuda.launches = 0
        ref.embedding_bag_ref.calls = 0
        outs = [ops.embedding_bag(table, sets["ragged"][0], "sum"),
                ops.embedding_bag(table, sets["ragged"][0], "mean"),
                ops.embedding_bag(table, sets["full"][0], "sum")]
        torch.cuda.synchronize()
        n, p = kernel.embedding_bag_cuda.launches, ref.embedding_bag_ref.calls
        check(n == 3 and p == 0, f"DLRM {name}: {n} kernel launches, {p} plain calls "
              "(expected 3 and 0)")
        launches += n
        plain_calls += p
        max_err = max(max_err, eb_same(outs[0], ref.embedding_bag_ref(table, sets["ragged"][0]),
                                       f"DLRM {name} ragged sum"))
        eb_same(outs[1], eb_mean_plain(table, sets["ragged"][0]), f"DLRM {name} ragged mean")
        eb_same(outs[2], ref.embedding_bag_ref(table, sets["full"][0]), f"DLRM {name} full sum")
        # the illustrative skewed (Zipf) bags, timed beside the uniform ones; not on
        # the main path
        outs.append(kernel.embedding_bag_cuda(table, sets["skewed"][0]))
        eb_same(outs[3], ref.embedding_bag_ref(table, sets["skewed"][0]),
                f"DLRM {name} skewed sum")
        for kind, out in (("ragged", outs[0]), ("full", outs[2]), ("skewed", outs[3])):
            args = [(table, idx) for idx in sets[kind]]
            lib_sets = [eb_library_args(table, idx) for idx in sets[kind]]
            # the yardstick computes the same sums: fp32 to rounding; bf16
            # within the rounding of up to 100 adds
            scale = float(out.float().abs().max())
            lib_err = float((eb_library(*lib_sets[0]).float() - out.float()).abs().max())
            check(lib_err <= (1e-5 if dtype == torch.float32 else 2.0**-4) * scale,
                  f"DLRM {name} {kind}: F.embedding_bag differs by {lib_err} (max |out| {scale})")
            t_k = device_ms(kernel.embedding_bag_cuda, args)
            t_p = device_ms(ref.embedding_bag_ref, args, calls=6, replays=4)
            try:
                t_l, how = device_ms(eb_library, lib_sets), "CUDA graph"
            except RuntimeError as exc:  # a yardstick, not a check of the port
                log(f"  F.embedding_bag could not be captured in a CUDA graph ({exc}); "
                    "timed eagerly with CUDA events")
                t_l, how = time_ms(eb_library, lib_sets, 50), "eager"
            e_k = time_ms(kernel.embedding_bag_cuda, args, 50)
            b_ms, b_by, nbytes = eb_bound(table, sets[kind][0])
            live = sets[kind][0][sets[kind][0] >= 0]
            rows = int(torch.unique(live).numel())
            timing[f"{kind} {name}"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                            library_ms=t_l)
            log(f"  time DLRM {kind} {name} (B {b}, T {t}, {live.numel()} live ids, {rows} "
                "distinct rows): device ms per call "
                f"(CUDA graph) kernel {t_k:.4f}, plain {t_p:.4f}, F.embedding_bag (live ids "
                f"with offsets, {how}) {t_l:.4f} (its max |diff| {lib_err:.3g}); eager kernel "
                f"{e_k:.4f}; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB); kernel "
                f"device time at {100 * b_ms / t_k:.1f}% of the bound")
            del args, lib_sets
        del table, sets, outs
        torch.cuda.empty_cache()
    log(f"  peak device memory in this phase {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"allocated; main-path launches {launches}, plain-version calls {plain_calls}")
    return dict(max_abs_err=max_err, launches=launches, plain_calls=plain_calls, timing=timing)


# ---------------------------------------------------------------------------
# DIN, DIEN and Wide&Deep serving at full width
# ---------------------------------------------------------------------------

def recsys_payloads(cfg, n: int, rng) -> list:
    """The serving CLI's payloads: a history of ids in [-1, item_vocab)
    (din, dien), or 40 sparse ids in [0, 10^6) and normal dense features
    (wide_deep)."""
    import numpy as np

    if cfg.kind == "wide_deep":
        return [(rng.integers(0, 10**6, (cfg.n_sparse,)).astype(np.int32),
                 rng.normal(size=(cfg.n_dense,)).astype(np.float32)) for _ in range(n)]
    return [rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
            for _ in range(n)]


def recsys_phase(arch: str) -> dict:
    """One recsys arch at its full CONFIG width, random weights from a
    seed: a `ServingEngine` (max_batch 8, K 10) answers 32 requests; DIEN
    through `RecsysMIPSRoute` (its stage-1 GRU tower, then `ivf_topk` at L
    18), DIN and Wide&Deep through `DenseCandidateRoute` over 500
    candidates. The answers are held to the plain path on the CPU (ids
    as sets but for boundary ties, scores within rtol 1e-5 / atol 1e-6);
    stage times and latency p50 / p99."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ivf_topk import kernel as ivk
    from repro_torch.kernels.ivf_topk import ops as ivops
    from repro_torch.kernels.ivf_topk import ref as ivref
    from repro_torch.mips.refresh import RefreshState
    from repro_torch.models import recsys
    from repro_torch.serve import (
        CoalescePolicy,
        DenseCandidateRoute,
        RecsysMIPSRoute,
        ServingEngine,
    )
    from repro_torch.serve.routes import _tree_to

    dev = torch.device("cuda")
    cfg = get_arch(arch).CONFIG
    params = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg.kind == "dien":
        route = RecsysMIPSRoute(cfg, params, k=K_SERVE, n_probe=N_PROBE, device=dev)
    else:
        route = DenseCandidateRoute(cfg, params, candidates=np.arange(500, dtype=np.int32),
                                    k=K_SERVE, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    payloads = recsys_payloads(cfg, RECSYS_REQUESTS, np.random.default_rng(0))
    engine = ServingEngine(route, CoalescePolicy(max_batch=MAX_BATCH, max_wait_s=0.002))
    engine.warmup()
    # the main path, counts set to 0 just before and read just after
    ivk.ivf_probe_topk_cuda.launches = 0
    ivref.ivf_probe_topk_ref.calls = 0
    for p in payloads:
        engine.submit(p, arrival=0.0)
    records = engine.drain()
    ivf_launches, ivf_plain = ivk.ivf_probe_topk_cuda.launches, ivref.ivf_probe_topk_ref.calls
    check(len(records) == RECSYS_REQUESTS, f"{arch}: answered {len(records)}/{RECSYS_REQUESTS}")
    check(ivf_plain == 0, f"{arch}: the ivf plain version ran {ivf_plain} times on the card")
    if cfg.kind == "dien":
        check(ivf_launches == 2 * engine.batches,
              f"dien: ivf_topk launched {ivf_launches} times for {engine.batches} batches "
              "(expected main + delta per batch)")
        check(not route.degraded, "dien: the serving path fell back to exact search")
    lats = [r.latency for r in records]

    # the plain path on the CPU, batch by batch, from the same weights
    got_ids = np.stack([r.result[0] for r in records])
    got_scores = np.stack([r.result[1] for r in records])
    t0 = time.perf_counter()
    tower_err = 0.0
    with torch.inference_mode():
        if cfg.kind == "dien":
            planner = route.planner
            cpu_params = _tree_to(planner.params, "cpu")
            cpu_state = RefreshState(*(x.cpu() for x in planner.index_state))
        else:
            cpu_route = DenseCandidateRoute(cfg, route.params,
                                            candidates=np.arange(500, dtype=np.int32),
                                            k=K_SERVE, device="cpu")
        for i in range(0, RECSYS_REQUESTS, MAX_BATCH):
            rows = slice(i, i + MAX_BATCH)
            if cfg.kind == "dien":
                hist = torch.from_numpy(np.stack(payloads[rows]))
                h_card = recsys.dien_user_vector(cfg, planner.params, hist.to(dev))
                h_cpu = recsys.dien_user_vector(cfg, cpu_params, hist)
                tower_err = max(tower_err, close_err(h_card, h_cpu, f"dien tower batch {i}",
                                                     sums=True))
                # retrieval on the card's user vectors (a near-tied centroid
                # score must not pick other lists)
                exp = ivops.ivf_topk(h_card.cpu(), cpu_state.as_index(cfg.item_vocab), K_SERVE,
                                     n_probe=planner.n_probe, delta=cpu_state.delta())
                exp = (exp.scores, exp.indices)
            else:
                exp = cpu_route.run(cpu_route.prepare(payloads[rows]))
            served = (torch.from_numpy(got_scores[rows]).cuda(),
                      torch.from_numpy(got_ids[rows]).cuda())
            topk_err(served, (exp[0].cuda(), exp[1].cuda()), f"{arch} batch {i // MAX_BATCH}")
    cpu_s = time.perf_counter() - t0
    tower = (f", tower max |diff| {tower_err:.3g} (atol scaled by max |h|)"
             if cfg.kind == "dien" else "")
    log(f"[recsys] {arch}: {RECSYS_REQUESTS}/{RECSYS_REQUESTS} answered in {engine.batches} "
        f"batches (route set up in {setup_s:.2f} s); latency p50 "
        f"{percentile(lats, 50) * 1e3:.3f} ms, p99 {percentile(lats, 99) * 1e3:.3f} ms; "
        f"ivf_topk launches {ivf_launches}"
        + (f" (L {cfg.embed_dim})" if cfg.kind == "dien" else "")
        + f", plain calls {ivf_plain}; answers match the plain "
        f"path on the CPU ({cpu_s:.1f} s){tower}")
    stage_times(route, payloads, records, f"recsys {arch}")
    res = dict(p50_ms=percentile(lats, 50) * 1e3, p99_ms=percentile(lats, 99) * 1e3,
               ivf_launches=ivf_launches, batches=engine.batches)
    if cfg.kind == "dien":
        res["ivf_l18"] = dien_ivf_times(route, payloads)
    return res


def dien_ivf_times(route, payloads) -> dict:
    """ivf_topk at DIEN's width (L 18) on the route's index, the user
    vectors of 4 served batches: device ms per call of the kernel and its
    plain version, and the bound."""
    import torch

    from repro_torch.kernels.ivf_topk import kernel as ivk
    from repro_torch.kernels.ivf_topk import ref as ivref

    planner = route.planner
    state = planner.index_state
    sets = []
    with torch.inference_mode():
        for i in range(0, 4 * MAX_BATCH, MAX_BATCH):
            x = route.prepare(payloads[i:i + MAX_BATCH])
            h = planner.policy.user_embedding(planner.params, x).float().contiguous()
            probe = torch.topk(h @ state.centroids.float().T, planner.n_probe, dim=1).indices
            sets.append((h, probe.to(torch.int32), state.lists, state.list_embs, K_SERVE))
        t_k = device_ms(ivk.ivf_probe_topk_cuda, sets)
        t_p = device_ms(ivref.ivf_probe_topk_ref, sets)
    b_ms, b_by, nbytes = bound_ms(*sets[0])
    c, capp = state.lists.shape
    log(f"  time ivf_topk DIEN shape (B={MAX_BATCH} L={sets[0][0].shape[1]} C={c} capp={capp} "
        f"n_probe={planner.n_probe} K={K_SERVE}, served users): device ms per call (CUDA graph) "
        f"kernel {t_k:.4f}, plain {t_p:.4f}; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} "
        f"MB); kernel at {100 * b_ms / t_k:.1f}% of the bound")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# recsys training at full width (phase 7b)
# ---------------------------------------------------------------------------

def tree_cpu(tree):
    """A parameter or optimizer-state tree with every tensor copied to the CPU."""
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def grads_seen(opt, seen: list, update: bool = True):
    """``opt`` with an update that also keeps the gradients it is handed
    (with ``update=False`` it only keeps them, and hands back the
    parameters and state unchanged)."""
    from repro_torch.optim import Optimizer

    def step(g, s_, p_):
        seen.append(g)
        return opt.update(g, s_, p_) if update else (p_, s_)

    return Optimizer(init=opt.init, update=step)


def recsys_train_phase() -> dict:
    """Recsys training at the full CONFIG widths (phase 7b), random weights
    from seed 0, Adam(1e-3), batches of 64 drawn as the launcher draws
    them: DIN, DIEN and Wide&Deep on BCE (RECSYS_BCE_STEPS steps each),
    SASRec on FOPO at 10^6 items (RECSYS_FOPO_STEPS, S 1000, K 256, eps
    0.8, the streaming top-K at block_items 8192; step p50 / p99) and
    DIEN on FOPO (DIEN_FOPO_STEPS); on FOPO two of a row's four positives
    come from its top-64 under the initial weights (the CLI's uniform
    ones would give no reward and a zero gradient at 10^6 items). Each path is replayed on the CPU
    (RECSYS_REPLAY_BCE and RECSYS_REPLAY_FOPO steps), each step from the
    card's parameters and Adam state before it, FOPO on the card's own
    actions and log q: loss within rtol 1e-5 / atol 1e-6, every parameter
    leaf by `theta_gate`; at the first FOPO step the CPU's top-K is held
    to the card's. No hand-written kernel is on this path (the retriever,
    the sampler and the surrogate are plain torch, as the reference's are
    plain JAX)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import recsys_batch
    from repro_torch.mips.streaming import topk_streaming
    from repro_torch.models import recsys
    from repro_torch.optim import adam
    from repro_torch.optim.optimizers import tree_leaves

    dev = torch.device("cuda")
    lr = 1e-3
    out = {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for arch, objective, steps in (("din", "bce", RECSYS_BCE_STEPS),
                                   ("dien", "bce", RECSYS_BCE_STEPS),
                                   ("wide-deep", "bce", RECSYS_BCE_STEPS),
                                   ("sasrec", "fopo", RECSYS_FOPO_STEPS),
                                   ("dien", "fopo", DIEN_FOPO_STEPS)):
        tag = f"{arch} {objective}"
        cfg = get_arch(arch).CONFIG
        t0 = time.perf_counter()
        params = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt = adam(lr)
        state = opt.init(params)
        record = []
        plan = None
        if objective == "fopo":
            plan = recording_plan(recsys.fopo_plan(cfg), record)
        step = recsys.make_train_step(cfg, opt, objective, plan=plan)
        rng = np.random.default_rng(0)
        batches = [recsys_batch(cfg, rng, objective) for _ in range(steps)]
        tower = recsys.sasrec_user_vector if cfg.kind == "sasrec" else recsys.dien_user_vector
        if objective == "fopo":
            # the CLI's positives are uniform over 10^6 items: no draw would
            # hit one and every gradient would be 0. Two of a row's four are
            # drawn from its top-64 under the initial weights instead.
            with torch.no_grad():
                for nb in batches:
                    h = tower(cfg, params, torch.from_numpy(nb["hist"]).to(dev))
                    top = topk_streaming(h, params["items"], 64, block_items=8192)
                    pick = rng.integers(0, 64, (h.shape[0], 2))
                    nb["positives"][:, :2] = np.take_along_axis(
                        top.indices.cpu().numpy(), pick, 1)
        n_params = sum(t.numel() for t in tree_leaves(params))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        replay_n = RECSYS_REPLAY_FOPO if objective == "fopo" else RECSYS_REPLAY_BCE
        starts, losses, times = [], [], []
        for i, nb in enumerate(batches):
            if i <= replay_n:  # the state before step i; the last one ends the replay
                starts.append((tree_cpu(params), tree_cpu(state)))
            batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
            t = time.perf_counter()
            params, state, loss = step(params, state, batch, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            check(math.isfinite(losses[-1]), f"{tag} step {i + 1}: loss {losses[-1]}")
        # the CPU replay, each step from the card's state before it
        t0 = time.perf_counter()
        cpu_opt = adam(lr)
        off, worst_loss, hits = 0, 0.0, []
        for i in range(replay_n):
            p0, s0 = starts[i]
            batch = {k: torch.from_numpy(v) for k, v in batches[i].items()}
            seen = []
            cstep = recsys.make_train_step(cfg, grads_seen(cpu_opt, seen), objective)
            kw = {}
            if objective == "fopo":
                topk, sample = record[i]
                kw["sample"] = type(sample)(*(t.cpu() for t in sample))
                if i == 0:
                    with torch.no_grad():
                        h = tower(cfg, p0, batch["hist"])
                        mine = topk_streaming(h, p0["items"], cfg.fopo_top_k, block_items=8192)
                    topk_err((topk.scores, topk.indices), (mine.scores, mine.indices),
                             f"{tag} step 1 top-K, card vs CPU")
            p1, _, loss = cstep(p0, s0, batch, i, **kw)
            if objective == "fopo":
                hit = (kw["sample"].actions[:, :, None] == batch["positives"][:, None, :]).any(-1)
                hits.append(float(hit.float().mean()))
            check(abs(float(loss) - losses[i]) <= 1e-6 + 1e-5 * abs(losses[i]),
                  f"{tag} replay step {i + 1}: loss {float(loss)} vs the card's {losses[i]}")
            worst_loss = max(worst_loss, abs(float(loss) - losses[i]))
            for g, a, b in zip(tree_leaves(seen[0]), tree_leaves(p1),
                               tree_leaves(starts[i + 1][0])):
                off += theta_gate(a, b, g, lr, f"{tag} replay step {i + 1}")
        cpu_s = time.perf_counter() - t0
        res = dict(p50_ms=percentile(times[1:], 50), p99_ms=percentile(times[1:], 99),
                   first_ms=times[0], losses=losses, n_params=n_params)
        out[tag] = res
        rows = cfg.field_vocab * 4 if cfg.kind == "wide_deep" else cfg.item_vocab
        draws = (f" on the card's draws, at most {100 * max(hits):.2f} % of them rewarded,"
                 if objective == "fopo" else "")
        log(f"[recsys-train] {tag}: {rows} rows x {cfg.embed_dim}, {n_params / 1e6:.1f} M "
            f"parameters, set up in {setup_s:.2f} s; {steps} steps of batch 64: loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}; step 1 {times[0]:.2f} ms, then p50 "
            f"{res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms; CPU replay of {replay_n} "
            f"steps{draws} ({cpu_s:.1f} s): loss max |diff| {worst_loss:.3g}, parameters by "
            f"theta_gate ({off} entries past 1e-6 where the gradient is near 0)")
        del params, state, starts, record, batches
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    secs = time.perf_counter() - t_phase
    log(f"[recsys-train] phase 7b took {secs:.1f} s, peak device memory {peak:.2f} GB")
    out.update(peak_gb=peak, seconds=secs)
    return out


# ---------------------------------------------------------------------------
# GraphCast training at full width (phase 7c)
# ---------------------------------------------------------------------------

def gnn_fixed_inputs(cell, n_vars: int, rng) -> tuple:
    """(feats, src, dst, targets, mask) as numpy for a cell whose graph is
    fixed: full_graph_sm's `random_graph(2708, avg_degree=4)` cut to its
    first 10,556 edges (the cell's count; messages from a CSR row's
    neighbours to the row), molecule's 128 block-diagonal graphs of 30
    nodes and 64 edges (no self-loops). Padded to the cell's
    `gnn.static_shape` (-1 edges, zero rows out of the loss)."""
    import numpy as np

    from repro_torch.data import random_graph
    from repro_torch.models import gnn

    if cell.global_batch:
        k, nn, ee = cell.global_batch, cell.n_nodes, cell.n_edges
        s = rng.integers(0, nn, (k, ee))
        d = (s + rng.integers(1, nn, (k, ee))) % nn
        off = (np.arange(k) * nn)[:, None]
        src, dst, n_real = (s + off).ravel(), (d + off).ravel(), k * nn
    else:
        g = random_graph(cell.n_nodes, avg_degree=4, seed=0)
        src = g.indices[:cell.n_edges]
        dst = np.repeat(np.arange(cell.n_nodes), np.diff(g.indptr))[:cell.n_edges]
        n_real = cell.n_nodes
    n, e = gnn.static_shape(cell)
    edges = np.full((2, e), -1, np.int32)
    edges[0, :len(src)], edges[1, :len(dst)] = src, dst
    feats = np.zeros((n, cell.d_feat), np.float32)
    feats[:n_real] = rng.standard_normal((n_real, cell.d_feat))
    targets = np.zeros((n, n_vars), np.float32)
    targets[:n_real] = rng.standard_normal((n_real, n_vars))
    mask = (np.arange(n) < n_real).astype(np.float32)
    return feats, edges[0], edges[1], targets, mask


def gnn_train_phase() -> dict:
    """GraphCast training at full width (phase 7c): `configs/graphcast.py:
    CONFIG` (16 layers, d_hidden 512, n_vars 227, sum, scan + remat, fp32;
    random weights from seed 0), `gnn.make_train_step` with Adam(1e-3),
    GNN_STEPS steps a cell (step 1 out of p50 / p99):
    minibatch_lg (the 232,965 x 602 feature table and the targets on the
    card; each step `sample_neighbors` on the host, 1024 seeds, fanout
    (15, 10), and `gnn.subgraph_inputs` gathers the subgraph's rows into
    the cell's `gnn.static_shape`, n 169,984 and e 168,960, the loss
    masked to the seeds; the graph `random_graph(232,965,
    avg_degree=GNN_DEGREE)`, its build timed), full_graph_sm and molecule
    (`gnn_fixed_inputs`). For each: step p50 / p99, host sampling, peak
    memory, a profiled step's idle share, model FLOPs a second
    (`launch.costs.gnn_model_flops`, the padded shapes; for minibatch_lg
    also at the sampled subgraphs' mean size) and their share of 67
    TFLOP/s fp32, and the same step run twice from one state (bitwise
    equal or the max |diff|: `index_add` adds with atomics). Then the CPU
    replay (full width but GNN_REPLAY_LAYERS layers, on full_graph_sm, in
    fp32 and fp64: the loss within rtol 1e-4 of the fp64 one, each
    gradient leaf within 2x the CPU fp32's distance from the fp64 one or
    within 1e-4 of its largest, the post-Adam parameters by `theta_gate`
    against the fp64 step) and the train CLI on the card. No hand-written
    kernel is on this path (the reference's GNN calls no Pallas kernel)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import random_graph, sample_neighbors
    from repro_torch.device import resolve_device
    from repro_torch.launch import costs
    from repro_torch.models import gnn
    from repro_torch.optim import adam
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    dev = resolve_device("cuda")  # IEEE fp32 matmuls (TF32 off)
    mod = get_arch("graphcast")
    cfg = mod.CONFIG
    lr, out, card = 1e-3, {}, card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)

    def to_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for name in ("minibatch_lg", "full_graph_sm", "molecule"):
        cell = mod.SHAPES[name]
        n, e = gnn.static_shape(cell)
        t0 = time.perf_counter()
        extra = ""
        if cell.batch_nodes:
            graph = random_graph(cell.n_nodes, avg_degree=GNN_DEGREE, seed=0)
            build_s = time.perf_counter() - t0
            gen = torch.Generator(device=dev).manual_seed(1)
            table = torch.randn((cell.n_nodes, cell.d_feat), generator=gen, device=dev)
            table_y = torch.randn((cell.n_nodes, cfg.n_vars), generator=gen, device=dev)
            extra = (f"graph random_graph({cell.n_nodes}, avg_degree={GNN_DEGREE}): "
                     f"{len(graph.indices)} edges built in {build_s:.2f} s; feature table "
                     f"{cell.n_nodes} x {cell.d_feat} ({table.numel() * 4 / 1e6:.0f} MB) and "
                     "targets on the device; ")

            def batch():
                """A sampled batch: (host seconds, a function that gathers it
                on the device, (nodes, valid edges))."""
                t = time.perf_counter()
                seeds = rng.choice(cell.n_nodes, cell.batch_nodes, replace=False)
                sub = sample_neighbors(graph, seeds, cell.fanout, rng)
                host_s = time.perf_counter() - t
                return (host_s, lambda: gnn.subgraph_inputs(sub, table, table_y, n, e),
                        (len(sub.node_ids), int((sub.edge_src >= 0).sum())))
        else:
            fixed = to_dev(gnn_fixed_inputs(cell, cfg.n_vars, rng))

            def batch():
                return 0.0, lambda: fixed, None
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        params = gnn.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                 d_feat=cell.d_feat)
        opt = adam(lr)
        state = opt.init(params)
        step = gnn.make_train_step(cfg, opt)
        times, host, losses, sizes = [], [], [], []
        for i in range(GNN_STEPS):
            host_s, gather, size = batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            inputs = gather()
            params, state, loss = step(params, state, *inputs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            host.append(host_s * 1e3)
            losses.append(float(loss))
            sizes.append(size)
            check(math.isfinite(losses[-1]), f"graphcast {name} step {i + 1}: loss {losses[-1]}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the same step twice from one state (the last batch)
        a = step(params, state, *inputs)
        b = step(params, state, *inputs)
        diff = max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])))
        same = diff == 0.0 and float(a[2]) == float(b[2])
        loss_diff = abs(float(a[2]) - float(b[2]))
        del a, b
        _, busy, prof_ms = device_profile(lambda: step(params, state, *inputs))
        idle = 100 * (1 - busy / prof_ms)
        flops = costs.gnn_model_flops(cfg, cell)
        p50, p99 = percentile(times[1:], 50), percentile(times[1:], 99)
        res = dict(p50_ms=p50, p99_ms=p99, first_ms=times[0], host_ms=percentile(host, 50),
                   peak_gb=peak, idle=idle, model_tflop=flops / 1e12,
                   tflops=flops / (p50 / 1e3) / 1e12, repeat_bitwise=same,
                   repeat_max_diff=diff, repeat_loss_diff=loss_diff, losses=losses)
        res["fp32_share"] = res["tflops"] * 1e12 / FP32_FLOPS
        out[name] = res
        sub = ""
        if cell.batch_nodes:
            # the work on the sampled nodes and valid edges alone: the padded
            # shapes' rows and edges past them are executed but carry nothing
            m_mean = sum(s[0] for s in sizes) / len(sizes)
            k_mean = sum(s[1] for s in sizes) / len(sizes)
            useful = costs.gnn_model_flops(cfg, dataclasses.replace(
                cell, batch_nodes=0, fanout=(), n_nodes=round(m_mean), n_edges=round(k_mean)))
            res.update(graph_build_s=build_s, useful_tflop=useful / 1e12,
                       useful_share=useful / (p50 / 1e3) / FP32_FLOPS)
            sub = (f"; host sampling p50 {res['host_ms']:.1f} ms a step (subgraphs of "
                   f"{min(s[0] for s in sizes)}-{max(s[0] for s in sizes)} nodes and "
                   f"{min(s[1] for s in sizes)}-{max(s[1] for s in sizes)} valid edges; at "
                   f"their mean size the model FLOPs are {useful / 1e12:.3f} T a step, "
                   f"{100 * res['useful_share']:.1f} % of 67 TFLOP/s fp32 at the p50)")
        log(f"[graphcast] {name}: {extra}n {n}, e {e}, d_feat {cell.d_feat}; set up in "
            f"{setup_s:.2f} s; {GNN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
            f"1 {times[0]:.1f} ms, then p50 {p50:.2f} ms, p99 {p99:.2f} ms{sub}; peak device "
            f"memory {peak:.2f} GB; model FLOPs at the padded shapes {flops / 1e12:.3f} T a step, "
            f"{res['tflops']:.2f} TFLOP/s at the p50, {100 * res['fp32_share']:.1f} % of 67 "
            f"TFLOP/s fp32; profiled step {prof_ms:.1f} ms, device idle {idle:.1f} %; the same "
            "step twice: "
            + ("bitwise equal" if same else f"not bitwise equal, parameters max |diff| "
               f"{diff:.3g}, loss |diff| {loss_diff:.3g}") + f" ({card})")
        del params, state, inputs, step
        if cell.batch_nodes:
            del graph, table, table_y
        torch.cuda.empty_cache()

    # the CPU replay: one step at full width, GNN_REPLAY_LAYERS layers,
    # full_graph_sm, in fp32 and in fp64 (the exact gradient to fp32's eye)
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=GNN_REPLAY_LAYERS)
    cell = mod.SHAPES["full_graph_sm"]
    arrays = gnn_fixed_inputs(cell, cfg.n_vars, np.random.default_rng(1))
    params = gnn.init_params(cfg2, torch.Generator(device=dev).manual_seed(2), d_feat=cell.d_feat)
    p0 = tree_cpu(params)
    seen = []
    p1, _, loss = gnn.make_train_step(cfg2, grads_seen(adam(lr), seen))(
        params, adam(lr).init(params), *to_dev(arrays))
    cpu = {}
    for dt in (torch.float32, torch.float64):
        p_dt = tree_map(lambda t: t.to(dt), p0)
        got = []
        c1, _, closs = gnn.make_train_step(cfg2, grads_seen(adam(lr), got))(
            p_dt, adam(lr).init(p_dt), *(torch.from_numpy(a).to(dt) if a.dtype == np.float32
                                         else torch.from_numpy(a) for a in arrays))
        cpu[dt] = (float(closs), got[0], c1)
    exact = cpu[torch.float64][0]
    check(abs(float(loss) - exact) <= 1e-4 * abs(exact),
          f"graphcast replay: loss {float(loss)} vs the CPU's {exact} (fp64)")
    rel, small, off = [], [], 0
    for gc, g32, g64, a, b in zip(tree_leaves(seen[0]), tree_leaves(cpu[torch.float32][1]),
                                  tree_leaves(cpu[torch.float64][1]), tree_leaves(p1),
                                  tree_leaves(cpu[torch.float64][2])):
        top = float(g64.abs().max())
        e_card = float((gc.double().cpu() - g64).abs().max())
        e_cpu = float((g32.double() - g64).abs().max())
        rel.append((e_card / top, e_cpu / top))
        # the card's fp32 within 2x the CPU fp32's distance from the exact
        # gradient, or within 1e-4 of the leaf's largest: the encoder's sums
        # over 3072 nodes sit ~1e-4 of their largest from it in fp32
        check(e_card <= max(1e-4 * top, 2 * e_cpu),
              f"graphcast replay gradient: {e_card:.3g} from the fp64 one against the CPU "
              f"fp32's {e_cpu:.3g} (largest {top:.3g})")
        # Adam's first step moves an entry by lr g / (|g| + eps). Where |g| is
        # at least 2 e_card the card's entry has its sign and half its size,
        # so the two moves differ by at most 2 lr eps e_card / g^2: 5e-7 (half
        # the gate, the rest for the parameters' fp32 rounding) where g^2 is
        # 4 lr eps e_card / 1e-6. Smaller entries are near 0, held within 2 lr
        near0 = max(1e-4 * top, 2 * e_card, math.sqrt(4 * lr * ADAM_EPS * e_card / 1e-6))
        small.append(near0 / top)
        off += theta_gate(b.float(), a, g64.float(), lr, "graphcast replay parameters",
                          small_below=near0)
    replay_s = time.perf_counter() - t0
    out["replay"] = dict(loss_diff=abs(float(loss) - exact), grad_rel=rel, near0=small,
                         noisy=off)
    log(f"[graphcast] CPU replay at full width, {GNN_REPLAY_LAYERS} layers, full_graph_sm: loss "
        f"{float(loss):.6f} on the card, |diff| from the CPU's fp64 {abs(float(loss) - exact):.3g}"
        f" (the CPU's fp32 {abs(cpu[torch.float32][0] - exact):.3g}); each gradient leaf's max "
        "|diff| from the fp64 one over its largest, card / CPU fp32: "
        + ", ".join(f"{c:.2g} / {f:.2g}" for c, f in rel) + " (held: the card within 2x the CPU "
        "fp32's or 1e-4); the post-Adam parameters by theta_gate against the fp64 step within "
        "1e-6, entries near 0 (|g| under " + ", ".join(f"{x:.2g}" for x in small)
        + f" of their leaf's largest) within 2 lr ({off} entries past 1e-6); {replay_s:.1f} s")
    del params, p0, p1, cpu, seen
    torch.cuda.empty_cache()

    # the train CLI on the card
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "graphcast",
         "--steps", "3"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = re.findall(r"^step (\d+): loss=([-0-9.]+)$", res.stdout, re.M)
    check(res.returncode == 0 and [i for i, _ in lines] == ["0", "1", "2"]
          and all(math.isfinite(float(x)) for _, x in lines),
          f"the train CLI --arch graphcast: rc {res.returncode}\n{res.stdout[-2000:]}"
          f"\n{res.stderr[-2000:]}")
    log(f"[graphcast] python -m repro_torch.launch.train --arch graphcast --steps 3 on the "
        f"card: losses {', '.join(x for _, x in lines)} ({time.perf_counter() - t0:.1f} s)")
    secs = time.perf_counter() - t_phase
    log(f"[graphcast] phase 7c took {secs:.1f} s ({card})")
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# flash attention (K9): kernel vs plain version
# ---------------------------------------------------------------------------

def tensor_core_ms(flops: float, passes: int, rate: float) -> float:
    """The least time of one product that the kernels run on the tensor
    cores in ``passes`` passes at ``rate``, or of the same product as fp32
    FMAs where that is less (so no kernel can read over 100 % of it)."""
    return min(passes * flops / rate, flops / FP32_FLOPS) * 1e3


def flash_bound(b, sq, skv, h, kv, d, itemsize, causal, window, q_offset) -> tuple:
    """(ms, "bytes" or "operations", bytes, flops of each product, note):
    q, k, v read once, out and lse written once; 2 D flops per unmasked
    (query, key) pair for each of q k^T and p v, counted as K9 runs them
    on the tensor cores: bf16 inputs q k^T in one pass (exact) and p v in
    three (p in three bf16 terms) at 989 TFLOP/s; fp32 inputs three tf32
    passes each (3xTF32) at 495. The two products' times add."""
    from repro_torch.kernels.flash_attention.kernel import attention_work

    flops, _, nbytes = attention_work(b, sq, skv, h, kv, d, itemsize, causal, window, q_offset)
    if itemsize == 2:
        t_o = tensor_core_ms(flops, 1, BF16_FLOPS) + tensor_core_ms(flops, 3, BF16_FLOPS)
        note = (f"q k^T {flops / 1e9:.2f} GFLOP x 1 + p v {flops / 1e9:.2f} GFLOP x 3 "
                "passes at the bf16 tensor-core rate")
    else:
        t_o = 2 * tensor_core_ms(flops, 3, TF32_FLOPS)
        note = f"q k^T and p v {flops / 1e9:.2f} GFLOP each x 3 tf32 passes at 495 TFLOP/s"
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, flops, note


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
    emulation = 0.0  # max |kernel - the CPU tests' emulation of its arithmetic|

    def inputs(b, sq, skv, h, kv, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))

    def plain(q, k, v, **kw):
        b, sq, h, d = q.shape
        n_rep = h // k.shape[2]
        fold = lambda x, r: x.transpose(1, 2).repeat_interleave(r, 1).reshape(b * h, -1, d)  # noqa: E731
        out, lse = fr.flash_attention_ref(fold(q, 1), fold(k, n_rep), fold(v, n_rep), **kw)
        return out.reshape(b, h, sq, d).transpose(1, 2), lse.reshape(b, h, sq)

    def emulated(q, k, v, **kw):
        b, sq, h, d = q.shape
        fold = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1], d)  # noqa: E731
        out, lse = fr.flash_attention_mma(fold(q), fold(k), fold(v), **kw)
        return out.reshape(b, h, sq, d).transpose(1, 2), lse.reshape(b, h, sq)

    def gate(tag, out, lse, ro, rl):
        if out.dtype == torch.bfloat16:
            e = close_err(out, ro, tag + " out", rtol=BF16_RTOL, atol=ATOL)
        else:
            e = close_err(out, ro, tag + " out", sums=True)
        return e, close_err(lse, rl, tag + " lse", atol=1e-5)

    def compare(tag, q, k, v, **kw):
        nonlocal emulation
        out, lse = fk.flash_attention_fwd_cuda(q, k, v, **kw)
        e, el = gate(tag, out, lse, *plain(q, k, v, **kw))
        key = "out_bf16" if q.dtype == torch.bfloat16 else "out_fp32"
        errs[key] = max(errs[key], e)
        errs["lse"] = max(errs["lse"], el)
        em = ""
        if tag == "small":
            ee = gate(tag + " vs emulation", out, lse, *emulated(q, k, v, **kw))
            emulation = max(emulation, *ee)
            em = f"; against the emulation {ee[0]:.3g}, lse {ee[1]:.3g}"
        b, sq, h, d = q.shape
        log(f"  {tag}: B={b} Sq={sq} Skv={k.shape[1]} H={h} KV={k.shape[2]} D={d} "
            f"{str(q.dtype)[6:]} {kw}: out max_abs_err {e:.3g}, lse {el:.3g}{em} ok")

    for dtype in (torch.float32, torch.bfloat16):
        for d in fk.HEAD_DIMS:
            compare("small", *inputs(2, 77, 77, 4, 2, d, dtype), logit_cap=50.0)
        compare("small", *inputs(1, 300, 300, 2, 2, 64, dtype), window=64)
        compare("small", *inputs(1, 130, 130, 4, 2, 16, dtype), window=8, logit_cap=50.0)
        compare("small", *inputs(1, 40, 130, 4, 2, 128, dtype), window=8, q_offset=90,
                logit_cap=50.0)
        compare("small", *inputs(2, 100, 100, 2, 1, 256, dtype), causal=False)

    timing = {}
    for tag, (b, s_, h, kv, d), kw, dtype in [
        ("gemma prefill", (LM_BATCH, LM_PROMPT, 8, 4, 256), dict(logit_cap=50.0),
         torch.bfloat16),
        ("gemma prefill local", (LM_BATCH, LM_PROMPT, 8, 4, 256),
         dict(logit_cap=50.0, window=4096), torch.bfloat16),
        ("training B 1 fp32", (1, LM_TRAIN_S, 8, 4, 256), dict(logit_cap=50.0), torch.float32),
        ("training B 1 bf16", (1, LM_TRAIN_S, 8, 4, 256), dict(logit_cap=50.0), torch.bfloat16),
        ("S 8192 window 4096", (1, 8192, 8, 4, 256), dict(logit_cap=50.0, window=4096),
         torch.bfloat16),
        # OLMoE-1B-7B: head_dim 128, a GQA group of 1, no soft-cap, no window
        ("olmoe prefill", (LM_BATCH, LM_PROMPT, 16, 16, 128), {}, torch.bfloat16),
        ("olmoe training B 1 fp32", (1, LM_TRAIN_S, 16, 16, 128), {}, torch.float32),
    ]:
        sets = [inputs(b, s_, s_, h, kv, d, dtype) for _ in range(2)]
        compare(tag, *sets[0], **kw)
        kern = lambda q, k, v: fk.flash_attention_fwd_cuda(q, k, v, **kw)  # noqa: E731
        ref_ = lambda q, k, v: plain(q, k, v, **kw)  # noqa: E731
        t_k = device_ms(kern, sets, calls=8, replays=5)
        t_p = device_ms(ref_, sets, calls=2, replays=3)
        e_k = time_ms(kern, sets, 10)
        item = 2 if dtype == torch.bfloat16 else 4
        b_ms, b_by, nbytes, _, note = flash_bound(b, s_, s_, h, kv, d, item, True,
                                                  kw.get("window"), 0)
        timing[tag] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"  time {tag} (B={b} S={s_} H={h} KV={kv} D={d} {str(dtype)[6:]} {kw}): device ms "
            f"per call (CUDA graph) kernel {t_k:.4f}, plain {t_p:.4f}; eager kernel {e_k:.4f}; "
            f"bound {b_ms:.4f} ms ({b_by}: {note}; {nbytes / 1e6:.2f} MB, "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); kernel at {100 * b_ms / t_k:.1f}% of "
            "the bound")
        if tag in ("gemma prefill", "olmoe prefill"):
            lib = flex_yardstick(sets, plain, kw)
            timing[tag]["library"] = lib
            if isinstance(lib["bf16"], float):
                timing[tag]["library_ms"] = lib["bf16"]
        del sets
    torch.cuda.empty_cache()
    log(f"  K9 against `ref.flash_attention_mma` (the CPU tests' emulation of its "
        f"arithmetic) at the small shapes, by the same gates: max_abs_err {emulation:.3g}")
    return dict(max_abs_err=max(errs.values()), errs=errs, timing=timing,
                emulation_err=emulation)



# ---------------------------------------------------------------------------
# flash attention backward (K10): kernel vs plain version
# ---------------------------------------------------------------------------

def flash_bwd_bound(b, sq, skv, h, kv, d, itemsize, causal, window, q_offset) -> tuple:
    """(ms, "bytes" or "operations", bytes, flops of each product, note):
    q, k, v, dO, lse and D read once, dq, dk, dv written once; 2 D flops
    per unmasked (query, key) pair for each of the five products (s, dp,
    dv, dq, dk), counted as K10 runs them on the tensor cores: bf16
    inputs s and dp in one pass (exact), dv, dq and dk in two (p and ds in
    two bf16 terms) at 989 TFLOP/s; fp32 inputs three tf32 passes each at
    495. The five products' times add."""
    from repro_torch.kernels.flash_attention.kernel import attention_work

    flops, _, nbytes = attention_work(b, sq, skv, h, kv, d, itemsize, causal, window, q_offset,
                                      backward=True)
    if itemsize == 2:
        t_o = 2 * tensor_core_ms(flops, 1, BF16_FLOPS) + 3 * tensor_core_ms(flops, 2, BF16_FLOPS)
        note = (f"5 products of {flops / 1e9:.2f} GFLOP: s, dp x 1 and dv, dq, dk x 2 passes "
                "at the bf16 tensor-core rate")
    else:
        t_o = 5 * tensor_core_ms(flops, 3, TF32_FLOPS)
        note = f"5 products of {flops / 1e9:.2f} GFLOP x 3 tf32 passes at 495 TFLOP/s"
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, flops, note


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
    emulation = 0.0  # max |kernel - the CPU tests' emulation of its arithmetic|

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

    def emulated(q, k, v, do, lse, dsum, **kw):
        """The CPU tests' emulation of the kernel's arithmetic, GQA read
        as the kernel reads it."""
        b, sq, h, d = q.shape
        skv, kv = k.shape[1], k.shape[2]
        dq, dk, dv = fr.flash_attention_bwd_mma(
            fold(q, 1), fold(k, 1), fold(v, 1), fold(do, 1), lse.reshape(b * h, sq),
            dsum.reshape(b * h, sq), **kw)
        unfold = lambda x, n: x.reshape(b, n, -1, d).transpose(1, 2)  # noqa: E731
        return unfold(dq, h), unfold(dk, kv), unfold(dv, kv)

    def gate(tag, got, want):
        es = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype == torch.bfloat16:  # one bf16 ulp, atol for fp32 sums in another order
                scale = float(w.float().abs().max())
                es.append(close_err(g, w, f"{tag} {name}", rtol=BF16_RTOL,
                                    atol=ATOL + RTOL * scale))
            else:
                es.append(close_err(g, w, f"{tag} {name}", sums=True))
        return es

    def compare(tag, args, **kw):
        nonlocal emulation
        got = fk.flash_attention_bwd_cuda(*args, **kw)
        es = gate(tag, got, plain(*args, **kw))
        key = "bf16" if args[0].dtype == torch.bfloat16 else "fp32"
        errs[key] = max(errs[key], *es)
        em = ""
        if tag == "small":
            ee = gate(tag + " vs emulation", got, emulated(*args, **kw))
            emulation = max(emulation, *ee)
            em = f"; against the emulation {max(ee):.3g}"
        q, k = args[0], args[1]
        log(f"  {tag}: B={q.shape[0]} Sq={q.shape[1]} Skv={k.shape[1]} H={q.shape[2]} "
            f"KV={k.shape[2]} D={q.shape[3]} {key} {kw}: max_abs_err dq {es[0]:.3g}, dk "
            f"{es[1]:.3g}, dv {es[2]:.3g}{em} ok")
        del got
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
        # OLMoE-1B-7B's training microbatch: head_dim 128, GQA group 1, no cap
        ("olmoe main path B 1", (1, LM_PROMPT, 16, 16, 128), {}, (torch.float32, torch.bfloat16)),
    ]:
        for dtype in dtypes:
            sets = [inputs(b, s_, s_, h, kv, d, dtype, **kw) for _ in range(2)]
            compare(tag, sets[0], **kw)
            kern = lambda *a: fk.flash_attention_bwd_cuda(*a, **kw)  # noqa: E731
            ref_ = lambda *a: plain(*a, **kw)  # noqa: E731
            t_k = device_ms(kern, sets, calls=6, replays=4)
            t_p = device_ms(ref_, sets, calls=2, replays=3)
            item = 2 if dtype == torch.bfloat16 else 4
            b_ms, b_by, nbytes, _, note = flash_bwd_bound(b, s_, s_, h, kv, d, item, True,
                                                          kw.get("window"), 0)
            key = f"{tag} {'bf16' if item == 2 else 'fp32'}"
            timing[key] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            log(f"  time {key} (B={b} S={s_} H={h} KV={kv} D={d} {kw}): device ms per call "
                f"(CUDA graph) kernel {t_k:.4f}, plain {t_p:.4f}; bound {b_ms:.4f} ms ({b_by}: "
                f"{note}; {nbytes / 1e6:.2f} MB, {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
                f"kernel at {100 * b_ms / t_k:.1f}% of the bound")
            if key == "training B 4 bf16":
                grads = plain(*sets[0], **kw)
                lib = flex_fwd_bwd_yardstick([st[:4] for st in sets], kw, grads)
                del grads
                timing[key]["library"] = lib
            del sets
            torch.cuda.empty_cache()
    log(f"  K10 against `ref.flash_attention_bwd_mma` (the CPU tests' emulation of its "
        f"arithmetic) at the small shapes, by the same gates: max_abs_err {emulation:.3g}")
    return dict(max_abs_err=max(errs.values()), errs=errs, timing=timing,
                emulation_err=emulation)


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


@contextlib.contextmanager
def moe_recorder(rec: list, routes: bool = False):
    """While open, each call of `moe_ffn` from `repro_torch.models.lm` (one a
    layer of a prefill, of a decode step or of a training microbatch)
    appends to ``rec`` its dropped_frac (a 0-dim tensor, read later), its
    capacity and, with ``routes``, what `route_gate` needs: its input x,
    the router's weights, each token's top-k experts (by its fp32 router
    logits), which of its assignments kept a slot (ranked by the
    reference's one-hot cumsum, apart from `moe_ffn`'s sort), and the gap
    between its k-th and (k+1)-th logits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import lm
    from repro_torch.models.moe import moe_capacity

    base = lm.moe_ffn

    def recorded(x, router_w, *args, num_experts_per_tok, **kw):
        out, aux = base(x, router_w, *args, num_experts_per_tok=num_experts_per_tok, **kw)
        k, e = num_experts_per_tok, router_w.shape[-1]
        cap = moe_capacity(x.shape[0], k, kw["capacity_factor"], e)
        entry = {"dropped": aux["dropped_frac"].detach(), "capacity": cap}
        if routes:
            with torch.no_grad():
                top = torch.topk(x.detach().float() @ router_w.detach().float(), k + 1, dim=-1)
                top_e = top.indices[:, :k]
                flat = top_e.reshape(-1)
                ranks = torch.cumsum(F.one_hot(flat, e).to(torch.int32), 0, dtype=torch.int32)
                pos = ranks.gather(1, flat[:, None])[:, 0] - 1
            entry.update(x=x.detach(), w=router_w.detach(), top_e=top_e,
                         keep=(pos < cap).reshape(-1, k),
                         gap=top.values[:, k - 1] - top.values[:, k])
        rec.append(entry)
        return out, aux

    lm.moe_ffn = recorded
    try:
        yield rec
    finally:
        lm.moe_ffn = base


def route_gate(ra: list, rb: list, tag: str) -> tuple[list, dict]:
    """Tokens that two runs of the same MoE calls (``ra`` the kernel path's
    records, ``rb`` the plain attention's) route differently, and why.
    A token whose top-k experts differ must sit at a near tie: under run A
    its gap between the k-th and (k+1)-th router logits is at most
    2 |x_A - x_B| max_e |w_e| (how far the inputs' difference can move two
    logits apart), with 1e-5 |x_A| max_e |w_e| for the logits' own fp32
    rounding. A token whose kept experts differ with the same top-k must
    come after such a token in the call's token-major order (its rank
    among an expert's assignments moved). Anything else fails. Returns
    (per call: a bool mask [T] of the tokens routed differently and the
    experts they touch in either run), counts)."""
    import torch

    check(len(ra) == len(rb) and len(ra) > 0, f"{tag}: {len(ra)} vs {len(rb)} MoE calls")
    out, n_re, n_sh, worst = [], 0, 0, 0.0
    for a, b in zip(ra, rb):
        re_ = (torch.sort(a["top_e"], 1).values != torch.sort(b["top_e"], 1).values).any(1)
        kept = [torch.sort(torch.where(r["keep"], r["top_e"], -1), 1).values for r in (a, b)]
        moved = re_ | (kept[0] != kept[1]).any(1)
        idx = torch.nonzero(re_).flatten()
        first = None
        if idx.numel():
            xa, xb = a["x"][idx].float(), b["x"][idx].float()
            wmax = float(a["w"].float().norm(dim=0).max())
            bound = 2 * (xa - xb).norm(dim=1) * wmax + 1e-5 * xa.norm(dim=1) * wmax
            gap = a["gap"][idx]
            far = gap > bound
            if bool(far.any()):
                check(False, f"{tag}: a token routed differently away from a near tie: logit "
                      f"gap {float(gap[far][0]):.4g} > bound {float(bound[far][0]):.4g}")
            worst = max(worst, float((gap / bound).max()))
            first = int(idx.min())
        shifted = moved & ~re_
        if bool(shifted.any()):
            check(first is not None and int(torch.nonzero(shifted).min()) > first,
                  f"{tag}: a token's kept experts differ with no earlier token rerouted")
        experts = torch.unique(torch.cat([a["top_e"][moved], b["top_e"][moved]]).flatten())
        out.append((moved, experts))
        n_re += int(re_.sum())
        n_sh += int(shifted.sum())
    return out, dict(rerouted=n_re, shifted=n_sh, worst_gap_over_bound=worst)


def drop_table(rec: list, n_layers: int) -> list[float]:
    """Per layer, the mean dropped_frac over the recorded calls (taken
    layer by layer, in order)."""
    import torch

    check(len(rec) % n_layers == 0, f"{len(rec)} MoE calls for {n_layers} layers")
    d = torch.stack([r["dropped"] for r in rec]).float().reshape(-1, n_layers)
    return [float(v) for v in d.mean(0).cpu()]


def moe_lm_gate(cfg, route, x, toks_k, dev) -> dict:
    """The MoE generation gate: the kernel path (K9) and the plain chunked
    attention, both re-run on batch 0 with their routing recorded: the
    prefill, then the decode teacher-forced on the kernel path's tokens
    (``toks_k``). Routing differences are held to `route_gate`; a row is
    set aside, and counted, once its compared token (the last prompt
    position, or the decoded token) was routed differently in some layer;
    the other rows are held to the dense gate's tolerances: hidden states
    within relative L2 LM_HIDDEN_REL in bf16, token disagreements only at
    near ties; then one prefill in fp32 (the weights upcast) within rtol
    1e-4 (atol 1e-4 max |h|)."""
    import torch

    from repro_torch.models import lm

    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    params, planner = route.params, route.planner
    state = planner.index_state
    unembed = params.get("unembed", params["embed"])
    aside = torch.zeros(LM_BATCH, dtype=torch.bool)
    caches, rels, rels_all, held, ties, agree = {}, [], [], [], [], 0
    counts = dict(rerouted=0, shifted=0, worst_gap_over_bound=0.0)

    def note(stats):
        counts["rerouted"] += stats["rerouted"]
        counts["shifted"] += stats["shifted"]
        counts["worst_gap_over_bound"] = max(counts["worst_gap_over_bound"],
                                             stats["worst_gap_over_bound"])

    for t in range(LM_GEN):
        rec, hs = {}, {}
        for path, c in (("kernel", cfg), ("plain", plain_cfg)):
            rec[path] = []
            with moe_recorder(rec[path], routes=True):
                if t == 0:
                    cache = lm.init_cache(c, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
                    hs[path], caches[path] = lm.prefill(c, params, x, cache, return_hidden=True)
                else:
                    hs[path], caches[path] = lm.decode_step(c, params, toks_k[:, t - 1],
                                                            caches[path], return_hidden=True)
        per_row = LM_PROMPT if t == 0 else 1
        moved, stats = route_gate(rec["kernel"], rec["plain"],
                                  "bf16 prefill" if t == 0 else f"bf16 decode step {t}")
        note(stats)
        for m, _ in moved:
            aside |= m.reshape(LM_BATCH, per_row)[:, -1].cpu()
        del rec
        hk, hp = hs["kernel"], hs["plain"]
        if t == 0:
            # the recorded re-run of the kernel path is the served one
            check(torch.equal(toks_k[:, 0], route.next_token(hk)),
                  "the recorded kernel prefill gives other tokens than the served run")
        live = ~aside.to(hk.device)
        rels_all.append(rel_l2(hk, hp))
        if bool(live.any()):
            rels.append(rel_l2(hk[live], hp[live]))
            check(rels[-1] <= LM_HIDDEN_REL,
                  f"step {t}: hidden states differ, relative L2 {rels[-1]} over the rows held")
        held.append(int(live.sum()))
        tp = route.next_token(hp)
        for r in range(LM_BATCH):
            a, b = int(toks_k[r, t]), int(tp[r])
            if a == b:
                agree += 1
                continue
            ok, why = near_tie(hk[r], hp[r], a, b, unembed, state.centroids, planner.n_probe)
            ties.append(f"step {t} row {r}: kernel {a} / plain {b}; {why}")
            check(ok, "a token disagreement away from a near tie: " + ties[-1])
    del caches
    log(f"[olmoe gate] bf16, kernel vs plain chunked attention over {LM_GEN} steps (prefill, "
        f"then decode teacher-forced): tokens routed differently {counts['rerouted']} (each at a "
        f"near tie: logit gap / bound at most {counts['worst_gap_over_bound']:.3g}), tokens "
        f"whose kept experts moved behind them {counts['shifted']}; rows held step by step "
        f"{held} of {LM_BATCH}; hidden states relative L2 max "
        f"{max(rels) if rels else float('nan'):.3g} over the rows held (<= {LM_HIDDEN_REL}), "
        f"over every row (not held) {max(rels_all):.3g}; token agreement "
        f"{agree}/{LM_BATCH * LM_GEN}" + "".join(f"\n[olmoe gate]   {s}" for s in ties))
    torch.cuda.empty_cache()

    # one prefill batch in fp32: the same weights upcast
    c32 = dataclasses.replace(cfg, dtype="float32")
    params32 = {k: (v.float() if torch.is_tensor(v) else {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    rec, outs = {}, {}
    for path, flash in (("kernel", True), ("plain", False)):
        cc = dataclasses.replace(c32, use_flash_kernel=flash)
        cache = lm.init_cache(cc, LM_BATCH, LM_PROMPT, device=dev)
        rec[path] = []
        t0 = time.perf_counter()
        with moe_recorder(rec[path], routes=True):
            outs[path], _ = lm.prefill(cc, params32, x, cache, return_hidden=True)
        torch.cuda.synchronize()
        log(f"[olmoe gate] fp32 prefill ({path} attention) {time.perf_counter() - t0:.2f} s")
        del cache
    moved, stats32 = route_gate(rec["kernel"], rec["plain"], "fp32 prefill")
    aside32 = torch.zeros(LM_BATCH, dtype=torch.bool)
    for m, _ in moved:
        aside32 |= m.reshape(LM_BATCH, LM_PROMPT)[:, -1].cpu()
    del rec, params32
    live = ~aside32.to(outs["kernel"].device)
    e32 = float("nan")
    if bool(live.any()):
        e32 = close_err(outs["kernel"][live], outs["plain"][live], "fp32 prefill hidden",
                        rtol=1e-4, atol=1e-4, sums=True)
    log(f"[olmoe gate] fp32 prefill, kernel vs plain: tokens routed differently "
        f"{stats32['rerouted']}, kept experts moved {stats32['shifted']}, rows set aside "
        f"{int(aside32.sum())}/{LM_BATCH}; the rest within rtol 1e-4 (atol 1e-4 max |h|): max abs "
        f"{e32:.3g}, relative L2 {rel_l2(outs['kernel'], outs['plain']):.3g}")
    del outs
    torch.cuda.empty_cache()
    return dict(bf16=dict(counts, rows_held=held, rel_max=max(rels) if rels else None,
                          rel_max_all_rows=max(rels_all),
                          token_agreement=agree / (LM_BATCH * LM_GEN)),
                fp32=dict(stats32, rows_aside=int(aside32.sum()), max_abs=e32))


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
    n_params += params["unembed"].numel() if "unembed" in params else 0
    moe = (f", {cfg.num_experts} experts of d_ff {cfg.moe_d_ff} top {cfg.num_experts_per_tok} at "
           f"capacity factor {cfg.capacity_factor} (decode {max(cfg.capacity_factor, 2.0)})"
           if cfg.num_experts else "")
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.dh}, d_ff {cfg.d_ff}{moe}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window}"
        f"{' on even layers' if cfg.local_global_alternating else ''}, caps "
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

    drops = {"prefill": [], "decode": []}  # MoE: each layer's dropped_frac, call by call
    for i in range(0, LM_REQUESTS, LM_BATCH):
        x = route.prepare(prompts[i:i + LM_BATCH])
        with moe_recorder(drops["prefill"]):
            (hidden, cache), _ = timed("prefill", lambda: route.prefill(x))
        hs, ts = [hidden], []
        for t in range(LM_GEN):
            tok, dr = timed("retrieval", lambda: route.next_token(hidden))
            ts.append(tok)
            if t + 1 < LM_GEN:
                with moe_recorder(drops["decode"]):
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
    drop_frac = None
    if cfg.num_experts:
        drop_frac = {k: drop_table(v, cfg.num_layers) for k, v in drops.items()}
        for k, v in drop_frac.items():
            log(f"[lm] moe_ffn dropped_frac by layer at {k} (mean over its "
                f"{len(drops[k]) // cfg.num_layers} calls; capacity {drops[k][0]['capacity']} a "
                "call): "
                + ", ".join(f"{d:.4f}" for d in v) + f"; mean {sum(v) / len(v):.4f}")
    del drops

    # where a batch's device time goes: one profiled batch
    x = route.prepare(prompts[:LM_BATCH])
    evs, busy, wall = device_profile(lambda: route.run(x))
    idle = 100 * (1 - busy / wall)
    flash_ms = sum(t for t, n, _ in evs if "flash_fwd" in n)
    ivf_ms = sum(t for t, n, _ in evs if "ivf_" in n)
    log(f"[lm] profiled batch: device busy {busy:.3f} of {wall:.3f} ms wall (profiled), idle "
        f"{idle:.1f}%; K9 {flash_ms:.3f} ms ({cfg.num_layers} launches), ivf_topk "
        f"{ivf_ms:.3f} ms ({2 * LM_GEN} launches)")
    log("[lm] top device entries (ms per batch): " + "; ".join(
        f"{n[:48]} {t:.3f}" for t, n, _ in sorted(evs, reverse=True)[:10]))

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

    if cfg.num_experts:
        gate = moe_lm_gate(cfg, route, route.prepare(prompts[:LM_BATCH]), tokens[0], dev)
        del hiddens, tokens, route, engine, params, planner, state
        torch.cuda.empty_cache()
        return dict(counts=counts, ivf_lm=ivf_lm, idle=idle, gate=gate, drop_frac=drop_frac,
                    token_agreement=gate["bf16"]["token_agreement"], prefill_ms=med["prefill"],
                    step_p50_ms=percentile(steps, 50), step_p99_ms=percentile(steps, 99),
                    tokens_per_s=served.size / makespan)

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
                idle=idle, prefill_ms=med["prefill"], step_p50_ms=percentile(steps, 50),
                step_p99_ms=percentile(steps, 99), tokens_per_s=served.size / makespan)


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
    from repro_torch.optim import adam
    from repro_torch.optim.optimizers import tree_leaves

    gcfg = dataclasses.replace(cfg, num_layers=LM_GATE_LAYERS)
    opt = adam(1e-3)
    params = lm.init_params(gcfg, torch.Generator(device=dev).manual_seed(1), dev)
    state = opt.init(params)
    x, y = batch[:, :-1], batch[:, 1:]
    names = [n for k, v in params.items()
             for n in ([f"layers.{m}" for m in v] if k == "layers" else [k])]
    out = {}
    for step, (loss_tol, grad_tol) in ((1, GATE_BF16), (2, GATE_FP32)):
        res, rec = {}, {}
        for path, flash in (("kernel", True), ("plain", False)):
            seen = []
            # the plain path's step only hands over its gradients: no update
            # (the two paths' updated states would not fit beside each other)
            train_step = lm.make_train_step(dataclasses.replace(gcfg, use_flash_kernel=flash),
                                            grads_seen(opt, seen, update=flash))
            with moe_recorder(rec.setdefault(path, []), routes=bool(gcfg.num_experts)):
                p_new, s_new, loss = train_step(params, state, x, y)
            res[path] = (p_new, s_new, float(loss), seen[0])
        (pk, sk, lk, gk), (_, _, lp, gp) = res["kernel"], res["plain"]
        check(math.isfinite(lk) and math.isfinite(lp),
              f"gate step {step}: loss not finite ({lk}, {lp})")
        rel_loss = abs(lk - lp) / abs(lp)
        # MoE: experts that a token routed differently reached, per layer, are
        # set aside in the expert and router gradients (see `route_gate`)
        aside, moved = {}, ""
        if gcfg.num_experts:
            diff, stats = route_gate(rec["kernel"], rec["plain"], f"gate step {step}")
            base = params["layers"]["router"]
            per = base.stride(0) * base.element_size()
            for (m, experts), r in zip(diff, rec["kernel"]):
                if bool(m.any()):
                    layer = (r["w"].data_ptr() - base.data_ptr()) // per
                    aside.setdefault(layer, set()).update(experts.tolist())
            moved = (f"; tokens routed differently {stats['rerouted']} (near ties), kept "
                     f"experts moved {stats['shifted']}, (layer, expert) pairs set aside "
                     f"{sum(len(v) for v in aside.values())}")
        del rec
        held = [held_slices(n, a, b, aside)
                for n, a, b in zip(names, tree_leaves(gk), tree_leaves(gp))]
        rels = [rel_l2(a, b) if a.numel() else 0.0 for a, b in held]  # an empty leaf: all aside
        del held
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
            f"params {got[0]}, moments {got[1]} after the step, as the reference's Adam{moved}")
        out[step] = dict(loss_rel=rel_loss, grad_rel=rels[worst])
        params, state = pk, sk
        del res, gk, gp
    del params, state
    torch.cuda.empty_cache()
    return out


def held_slices(name: str, a, b, aside: dict):
    """A gradient leaf of the kernel and the plain path without the (layer,
    expert) slices in ``aside`` ({layer: experts}): the experts' weights
    [L, E, ...] and the router's columns [L, d, E]; other leaves whole."""
    import torch

    if not aside or name not in ("layers.router", "layers.we_gate", "layers.we_up",
                                 "layers.we_down"):
        return a, b
    if name == "layers.router":
        a, b = a.transpose(1, 2), b.transpose(1, 2)
    keep = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    for layer, experts in aside.items():
        keep[layer, sorted(experts)] = False
    return a[keep], b[keep]


def lm_train_phase(cfg=None, dev=None, steps: int = LM_TRAIN_STEPS) -> dict:
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
               .to(dev) for _ in range(steps + 1)]
    counters = [(fk.flash_attention_fwd_cuda, "launches"),
                (fk.flash_attention_bwd_cuda, "launches"),
                (fr.flash_attention_ref, "calls"), (fr.flash_attention_bwd_ref, "calls")]
    per_step = (2 * cfg.num_layers * n_micro, cfg.num_layers * n_micro)  # K9 (remat), K10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for fn, attr in counters:
        setattr(fn, attr, 0)
    for i in range(steps):
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
    log(f"[lm-train] {steps} steps: step 1 (bf16) {times[0] * 1e3:.1f} ms; fp32 steps "
        f"p50 {p50:.1f} ms, p99 {percentile(fp32_ms, 99):.1f} ms over {len(fp32_ms)}; "
        f"{tokens / (p50 / 1e3):.1f} tokens/s at the fp32 p50 ({tokens / times[0]:.1f} at step "
        f"1); peak device memory {peak / 1e9:.2f} GB allocated; counts {counts} "
        f"({per_step[0]} K9 and {per_step[1]} K10 launches per step)")

    # where a step's device time goes: one more step, profiled
    toks = batches[-1]
    evs, busy, wall = device_profile(
        lambda: train_step(params, state, toks[:, :-1], toks[:, 1:]))
    idle = 100 * (1 - busy / wall)
    k9 = sum(t for t, n, _ in evs if "flash_fwd" in n)
    k10 = sum(t for t, n, _ in evs if "flash_bwd" in n)
    log(f"[lm-train] profiled fp32 step: device busy {busy:.1f} of {wall:.1f} ms wall "
        f"(profiled), idle {idle:.1f}%; K9 {k9:.1f} ms ({per_step[0]} launches), K10 "
        f"{k10:.1f} ms ({per_step[1]} launches)")
    log("[lm-train] top device entries (ms per step): " + "; ".join(
        f"{n[:48]} {t:.1f}" for t, n, _ in sorted(evs, reverse=True)[:10]))
    del params, state
    torch.cuda.empty_cache()

    gate = lm_train_gate(cfg, batches[0], dev)
    return dict(counts=counts, step1_ms=times[0] * 1e3, p50_ms=p50,
                p99_ms=percentile(fp32_ms, 99), tokens_per_s=tokens / (p50 / 1e3), peak=peak,
                idle=idle, gate=gate)


def lm_head_phase(cfg, dev=None) -> dict:
    """`fopo_lm_head_loss` at full width (phase 11b): the final hidden
    states [N, d] of one LM_PROMPT-token prompt (the first served one) of
    ``cfg`` with its weights from seed 0, the frozen unembedding [V, d],
    the config's defaults (S 256, K 128, eps 0.5, the streaming top-K at
    block_items 8192) and `examples/lm_fopo_head.py`'s reward (tokens
    100-199), in fp32. The loss on its own draws and on the same draws
    made from its pieces (the streaming top-K, `MixtureProposal` from the
    same seed) agree; the loss, ESS and the hidden states' gradient are
    held to the CPU on those draws (loss rtol 1e-5 / atol 1e-7, gradient
    rtol 1e-4 / atol 1e-6 max |grad|, the CPU test's tolerances). No
    hand-written kernel is on this path."""
    import numpy as np
    import torch

    from repro_torch.core import FopoLMHeadConfig, fopo_lm_head_loss
    from repro_torch.core.proposals import MixtureProposal
    from repro_torch.mips.streaming import topk_streaming
    from repro_torch.models import lm

    dev = torch.device(dev or "cuda")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LM_PROMPT))).to(dev)
    with torch.inference_mode():
        hidden = lm.final_hidden(cfg, params, prompt)[0].float()
    emb = params.get("unembed", params["embed"]).float()
    del params
    torch.cuda.empty_cache()
    hcfg = FopoLMHeadConfig(vocab_size=cfg.vocab_size)

    def rewards(actions):
        return ((actions >= 100) & (actions < 200)).float()

    def run(h0, e, **kw):
        h = h0.clone().requires_grad_(True)
        loss, aux = fopo_lm_head_loss(h, e, rewards, 0, hcfg, **kw)
        (grad,) = torch.autograd.grad(loss, h)
        return loss.detach(), aux["ess"], grad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, ess, grad = run(hidden, emb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        topk = topk_streaming(hidden, emb, hcfg.top_k, hcfg.block_items)
        sample = MixtureProposal(hcfg.vocab_size, hcfg.epsilon).sample(
            torch.Generator(device=dev).manual_seed(0), topk.indices, topk.scores,
            hcfg.num_samples)
    loss2, _, grad2 = run(hidden, emb, sample=sample)
    close_err(loss2, loss, "lm head: the pieces' draws vs its own", rtol=1e-6, atol=0.0)
    close_err(grad2, grad, "lm head grad: the pieces' draws vs its own", rtol=1e-6, atol=0.0)
    hits = float(rewards(sample.actions).mean())
    t0 = time.perf_counter()
    cpu_sample = type(sample)(*(t.cpu() for t in sample))
    lc, essc, gc = run(hidden.cpu(), emb.cpu(), sample=cpu_sample)
    cpu_s = time.perf_counter() - t0
    el = close_err(loss, lc, "lm head loss, card vs CPU", rtol=1e-5, atol=1e-7)
    close_err(ess, essc, "lm head ESS, card vs CPU", rtol=1e-5, atol=0.0)
    eg = close_err(grad, gc, "lm head grad, card vs CPU", rtol=1e-4, atol=1e-6, sums=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    secs = time.perf_counter() - t_phase
    log(f"[lm-head] {cfg.name}: fopo_lm_head_loss over N {hidden.shape[0]} hidden states of d "
        f"{hidden.shape[1]}, vocab {cfg.vocab_size}, S {hcfg.num_samples}, K {hcfg.top_k}, eps "
        f"{hcfg.epsilon}, streaming top-K (block_items {hcfg.block_items}), fp32: loss "
        f"{float(loss):.6g}, ESS {float(ess):.4g}, reward (tokens 100-199) in {100 * hits:.2f}% "
        f"of the draws; loss and gradient {ms:.2f} ms on the card; the same draws from its "
        f"pieces agree; CPU on the card's draws ({cpu_s:.1f} s): loss |diff| {el:.3g}, gradient "
        f"max |diff| {eg:.3g}; phase {secs:.1f} s, peak device memory {peak:.2f} GB")
    del hidden, emb, grad, grad2, gc, sample, topk
    torch.cuda.empty_cache()
    return dict(loss=float(loss), ess=float(ess), ms=ms, loss_err=el, grad_err=eg, peak_gb=peak,
                seconds=secs)


def olmoe_phase() -> dict:
    """OLMoE-1B-7B on the card (phase 11b): generation at full width through
    `lm_phase` (K9 prefill, K7 greedy head at L 2048, its MoE gate), training
    cut to OLMOE_TRAIN_LAYERS layers through `lm_train_phase` (K9, K10, the
    gate's routing), then the FOPO LM head at full width."""
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch("olmoe-1b-7b").CONFIG
    t0 = time.perf_counter()
    gen = lm_phase(cfg=cfg)
    torch.cuda.empty_cache()
    log(f"[olmoe] generation phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train = lm_train_phase(cfg=dataclasses.replace(cfg, num_layers=OLMOE_TRAIN_LAYERS),
                           steps=OLMOE_TRAIN_STEPS)
    torch.cuda.empty_cache()
    log(f"[olmoe] training phase ({OLMOE_TRAIN_LAYERS} of {cfg.num_layers} layers, the rest at "
        f"full width) {time.perf_counter() - t0:.1f} s")
    head = lm_head_phase(cfg)
    return dict(gen=gen, train=train, head=head)


def sass_of(source) -> str:
    """The SASS of a built library (`cuobjdump -sass`)."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", str(_build._target(source))], capture_output=True,
                          text=True, check=True).stdout


def hmma_count(source) -> int:
    """The tensor-core instructions (`HMMA`) in the SASS of a built
    library: what shows that its products run on the tensor cores."""
    return len(re.findall(r"\bHMMA\.", sass_of(source)))


# SASS that moves control or data but computes nothing on a draw's
# values: branches and convergence, moves, constant and special-register
# reads, the uniform datapath, barriers and the exit
_NOT_WORK = re.compile(r"^(?:BRA|BSSY|BSYNC|BREAK|WARPSYNC|NOP|EXIT|BAR|MOV|IMAD\.MOV|HFMA2\.MMA"
                       r"|PLOP3|LDC|ULDC|S2R|S2UR|CS2R|U[A-Z])")


def sampler_instructions(sass: str) -> tuple[float, int, int]:
    """K5's work in 32-bit instructions, from the SASS of its kernel
    (`_NOT_WORK` left out): per Gumbel slot, the body of the innermost
    loop that holds the splitmix32 hash's 0x21f0aaad multiply most often
    (the unrolled slot loop) over that count (one hash a slot); per
    kappa-arm and per uniform-arm draw, the fewest that any draw of the
    arm issues after the kernel's last barrier (the shortest path to the
    exit through its arm's code: a kappa-arm draw's rank (`POPC`) and its
    log q in the row (the `MUFU.EX2` of its logaddexp); a uniform-arm
    draw's hash, missing the table, as all but ~K / P of them do)."""
    import heapq

    fn = sass[sass.index("fused_sampler_kernel"):]
    nxt = fn.find("Function :", 1)
    fn = fn if nxt < 0 else fn[:nxt]
    ins = [(int(a, 16), text.strip()) for a, text in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    op = [re.sub(r"^@!?U?P\w+\s+", "", t) for _, t in ins]
    work = [0 if _NOT_WORK.match(o) else 1 for o in op]
    at = {a: i for i, (a, _) in enumerate(ins)}
    target = [None] * len(ins)
    for i, o in enumerate(op):
        m = re.match(r"BRA\S*\s+(?:\S+,\s*)?(?:`\()?(?:\.L_x_\d+\))?\s*0x([0-9a-f]+)", o)
        if m:
            target[i] = at.get(int(m.group(1), 16))
    loops = [(target[i], i) for i in range(len(ins)) if target[i] is not None and target[i] < i]
    best = None
    for lo, hi in loops:
        if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue  # not innermost
        hashes = sum("0x21f0aaad" in op[i] for i in range(lo, hi + 1))
        if hashes and (best is None or hashes > best[1]):
            best = (sum(work[lo:hi + 1]), hashes)
    check(best is not None, "fused_sampler: no Gumbel loop found in its SASS")

    def shortest(marks) -> int:
        # Dijkstra over (instruction, marks passed); an edge costs the
        # instruction it leaves, the exit ends a path with every mark
        first = max(i for i, t in enumerate(op) if t.startswith("BAR.SYNC")) + 1
        full = (1 << len(marks)) - 1
        seen, heap = set(), [(0, first, 0)]
        while heap:
            cost, i, got = heapq.heappop(heap)
            if (i, got) in seen:
                continue
            seen.add((i, got))
            got |= sum(1 << j for j, mk in enumerate(marks) if mk(op[i]))
            if op[i].startswith("EXIT") and got == full:
                return cost
            uncond = ins[i][1] == op[i]  # no guard predicate
            nexts = []
            if target[i] is not None:
                nexts.append(target[i])
            if not (uncond and (op[i].startswith("EXIT") or
                                (target[i] is not None and not op[i].startswith("BRA.DIV")))):
                nexts.append(i + 1)
            for j in nexts:
                if j < len(ins):
                    heapq.heappush(heap, (cost + work[i], j, got))
        check(False, "fused_sampler: no path through an arm's code in its SASS")

    kappa = shortest([lambda o: o.startswith("POPC"), lambda o: o.startswith("MUFU.EX2")])
    uniform = shortest([lambda o: "0x21f0aaad" in o])
    return best[0] / best[1], kappa, uniform


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as `nvidia-smi` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


# ---------------------------------------------------------------------------
# multiple devices: the dist step (phase 5f)
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_config(dist, retriever: str = "streaming", health=None, index_refresh=None):
    """fopo-paper at full width (P 750,000, L 100, S 1000, K 256, eps 0.8,
    batch 32) through the fused covgrad kernels and the fused sampler, TS
    8, on the grid ``dist`` (None: one device)."""
    from repro_torch.configs import get_arch
    from repro_torch.train import TrainerConfig

    paper = get_arch("fopo-paper").CONFIG
    fopo = dataclasses.replace(paper.fopo, retriever=retriever, fused=True, fused_sampler=True,
                               sample_tile=TS, dist=dist, index_refresh=index_refresh)
    return TrainerConfig(estimator="fopo", fopo=fopo, batch_size=paper.batch_size,
                         learning_rate=paper.learning_rate, num_steps=DIST_STEPS, seed=0,
                         health=health)


def step_recording_plan(plan, record: list, replay: list | None = None, keep_state=()):
    """A copy of ``plan`` that records each step's user vectors, top-K,
    draws and rewards (and, at the steps in ``keep_state``, the index
    state it retrieved from); with ``replay`` (a list of TopK) the step
    takes that top-K in place of its own retrieval."""
    base = type(plan)

    class Recording(base):
        def retrieve(self, h, beta, index_state=None):
            t = len(record)
            top = replay[t] if replay is not None else base.retrieve(self, h, beta, index_state)
            record.append({"h": h, "topk": top,
                           "state": index_state if t in keep_state else None})
            return top

        def _draw_mixture(self, seed, topk, eps):
            out = base._draw_mixture(self, seed, topk, eps)
            record[-1]["sample"] = out
            return out

        def surrogate(self, policy, params, x, beta, sample, rewards):
            record[-1]["rewards"] = rewards
            return base.surrogate(self, policy, params, x, beta, sample, rewards)

    return Recording(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)})


def training_counters():
    """(wrapper or plain version, attribute) of every training kernel."""
    from repro_torch.kernels.fused_sampler import kernel as fk, ref as fr
    from repro_torch.kernels.ivf_topk import kernel as ik, ref as ir
    from repro_torch.kernels.mips_topk import kernel as mk, ref as mr
    from repro_torch.kernels.snis_covgrad import kernel as sk, ref as sr

    return [(mk.mips_topk_cuda, "launches"), (fk.fused_sampler_cuda, "launches"),
            (sk.snis_fwd_cuda, "launches"), (sk.snis_bwd_cuda, "launches"),
            (ik.ivf_probe_topk_cuda, "launches"), (mr.mips_topk_ref, "calls"),
            (fr.fused_sampler_ref, "calls"), (sr.snis_fwd_ref, "calls"),
            (sr.snis_bwd_ref, "calls"), (ir.ivf_probe_topk_ref, "calls")]


def zero_counts() -> None:
    for fn, attr in training_counters():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in training_counters()}


def state_checksum(state):
    """[2 x fields] int64: each field's 32-bit words summed exactly, all of
    them and every 7th (replicas hold equal states iff these agree, but
    for a collision)."""
    import torch

    out = []
    for t in state:
        w = t.contiguous().view(-1).view(torch.int32) if t.dtype != torch.int32 else t.view(-1)
        out += [w.sum(dtype=torch.int64), w[::7].sum(dtype=torch.int64)]
    return torch.stack(out)


def snapshot(tr) -> dict:
    """theta and Adam's state of a trainer, on the host."""
    st = tr.opt_state
    return {"w": tr.params["w"].cpu().clone(), "m": st["m"]["w"].cpu().clone(),
            "v": st["v"]["w"].cpu().clone(), "step": st["step"].cpu().clone()}


def grad_tree(dev, seed: int):
    """A GraphCast-sized gradient tree: graphcast's CONFIG at d_feat 602 (16
    leaves, 26,149,091 fp32 entries), N(0, 1) entries times 10^-(1 + i % 4)
    in leaf i, from a generator on ``dev`` seeded ``seed``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.optim.optimizers import tree_map

    gen = torch.Generator(device=dev).manual_seed(seed)
    scales = (10.0 ** -(1 + i % 4) for i in range(10**6))
    return tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev) * next(scales),
                    gnn.init_params(get_arch("graphcast").CONFIG, gen, 602))


def compression_drill(dev, seed: int, group=None) -> dict:
    """`compressed_all_reduce` of `grad_tree(dev, seed)` over ``group``,
    then a plain fp32 all-reduce of the same tree (`collectives.all_reduce`
    a leaf): this rank's `quantize_int8` outputs (q, scale) and its
    compressed result a leaf, on the host, and each run's `STATS` and
    wall ms (from a synchronised start to a synchronised end)."""
    import torch

    from repro_torch.dist import collectives as C
    from repro_torch.optim.compression import compressed_all_reduce, quantize_int8
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    t_drill = time.perf_counter()
    tree = grad_tree(dev, seed)
    out = {"q": [], "scale": []}
    for x in tree_leaves(tree):
        q, scale = quantize_int8(x)
        out["q"].append(q.cpu().numpy())
        out["scale"].append(scale.cpu().numpy())
    # the backend's first int32 and fp32 all-reduces of this size, untimed
    first = tree_leaves(tree)[0]
    C.all_reduce(first.to(torch.int32), group=group)
    C.all_reduce(first, group=group)
    runs = (("compressed", lambda: compressed_all_reduce(tree, group)),
            ("plain", lambda: tree_map(lambda g: C.all_reduce(g, group=group, name="plain_fp32"),
                                       tree)))
    for tag, fn in runs:
        C.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{tag}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{tag}_stats"] = {k: dict(v) for k, v in C.STATS.items()}
        if tag == "compressed":
            out["result"] = [r.cpu().numpy() for r in tree_leaves(res)]
        del res
    out["drill_s"] = time.perf_counter() - t_drill
    return out


def compression_gate(drills: list, tag: str) -> float:
    """Each rank's compressed result against the formula on the CPU, built
    from the ranks' own `quantize_int8` outputs: the int32 sum of their q
    times the mean of their scales. The int32 sum exactly (result / mean
    scale rounds back to it), the value within rtol 4e-7 (the backend may
    add the scales in another order). Returns the max |diff|."""
    import numpy as np
    import torch

    worst = 0.0
    for i in range(len(drills[0]["q"])):
        q_sum = sum(torch.from_numpy(d["q"][i]).to(torch.int32) for d in drills)
        scales = [torch.from_numpy(np.asarray(d["scale"][i])) for d in drills]
        mean = sum(scales[1:], scales[0]) / len(drills)
        want = q_sum.float() * mean
        for r, d in enumerate(drills):
            got = torch.from_numpy(d["result"][i])
            check(torch.equal(torch.round(got / mean).to(torch.int32), q_sum),
                  f"{tag} leaf {i}, rank {r}: the int32 sum differs from the formula's")
            worst = max(worst, close_err(got, want, f"{tag} leaf {i}, rank {r}", rtol=4e-7,
                                         atol=0.0))
    return worst


def compression_line(drill: dict, err: float, world: int) -> str:
    """The log line of a compression drill: bytes, calls and host ms from
    `STATS`, the wall ms, beside the plain fp32 all-reduce."""
    comp, plain = drill["compressed_stats"], drill["plain_stats"]
    cb = sum(v["bytes"] for v in comp.values())
    pb = sum(v["bytes"] for v in plain.values())
    numel = sum(q.size for q in drill["q"])
    return (f"{len(drill['q'])} leaves, {numel} fp32 entries a rank, world of {world}: "
            "compressed_all_reduce " + ", ".join(
                f"{k} {v['calls']} calls {v['bytes']} B {v['seconds'] * 1e3:.2f} "
                "host ms" for k, v in comp.items())
            + f", {drill['compressed_ms']:.2f} ms wall; plain fp32 all-reduce " + ", ".join(
                f"{k} {v['calls']} calls {v['bytes']} B {v['seconds'] * 1e3:.2f} "
                "host ms" for k, v in plain.items())
            + f", {drill['plain_ms']:.2f} ms wall (after one untimed all-reduce of each "
            f"dtype); bytes compressed / plain {cb / pb:.6f}; the drill {drill['drill_s']:.1f} s; "
            f"every rank's result equals the formula from the ranks' own quantize_int8 "
            f"outputs (int32 sum exact, max |diff| {err:.3g})")


def dist_rank_main(rank: int, port: int, tmp: str) -> int:
    """One rank of drill B (spawned by `dist_phase`): the gloo grid data 2
    x model 2 on the one card. The kernels were built by phase 2: a rank
    loads them and never starts nvcc. Writes its records to ``tmp``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch.data import SessionDataset
    from repro_torch.dist import collectives as C
    from repro_torch.dist.fopo import dist_scores, make_debug_dist
    from repro_torch.health.faults import FaultPlan
    from repro_torch.health.guard import HealthConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_sampler import kernel as fk
    from repro_torch.kernels.ivf_topk import kernel as ik, ops as iops
    from repro_torch.kernels.snis_covgrad import kernel as sk
    from repro_torch.mips.ivf import DEFAULT_N_PROBE, ShardedIVFIndex
    from repro_torch.mips.refresh import RefreshConfig, RefreshState
    from repro_torch.mips.sharded import merge_topk_along_axis
    from repro_torch.train import FOPOTrainer
    from repro_torch.train.checkpoint import restore_sharded, save_sharded

    for src in (fk.SOURCE, sk.FWD_SOURCE, sk.BWD_SOURCE, ik.SOURCE):
        check(_build._target(src).exists(), f"rank {rank}: {src.name} was not built by phase 2")

    def no_nvcc():
        raise RuntimeError("a rank of the dist drill started a kernel build")

    _build._nvcc = no_nvcc
    t_rank = time.perf_counter()
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4,
                             rank=rank, timeout=datetime.timedelta(seconds=300))
    d = make_debug_dist(2, 2)
    path = Path(tmp)
    items = np.load(path / "items.npy", mmap_mode="r")
    ds = SessionDataset(contexts=np.load(path / "contexts.npy"),
                        positives=np.load(path / "positives.npy"), item_embeddings=items,
                        num_items=items.shape[0])
    theta0 = {"w": torch.from_numpy(np.load(path / "theta0.npy"))}
    seeds = np.load(path / "seeds.npy")
    kw = dict(device=dev, params=theta0, step_seeds=lambda step: int(seeds[step]))
    out, info = {}, {"rank": rank, "coords": [d.data_rank, d.model_rank],
                     "backend": tdist.get_backend()}

    def run(tr, steps, tag, every=None):
        """``steps`` steps one at a time: losses, step times, snapshots,
        the collectives' bytes and host seconds a step."""
        C.reset_stats()
        zero_counts()
        losses, times, snaps = [], [], []
        for t in range(steps):
            if every is not None:
                every(t)
            h = tr.train(1)
            losses += h["loss"]
            times += h["step_time"]
            snaps.append(snapshot(tr))
        info[f"{tag}_counts"] = read_counts()
        info[f"{tag}_p50_ms"] = percentile(times[1:], 50) * 1e3
        info[f"{tag}_collectives"] = {k: {"bytes_per_step": v["bytes"] / steps,
                                          "calls_per_step": v["calls"] / steps,
                                          "ms_per_step": v["seconds"] * 1e3 / steps}
                                      for k, v in C.STATS.items()}
        for key in ("w", "m", "v"):
            out[f"{tag}/{key}"] = torch.stack([s[key] for s in snaps]).numpy()
        out[f"{tag}/loss"] = np.asarray(losses)
        return snaps

    # the sharded exact route: 20 steps, every step recorded
    rec: list = []
    tr = FOPOTrainer(dist_config(d), ds, **kw)
    tr.plan = step_recording_plan(tr.plan, rec)
    run(tr, DIST_STEPS, "exact")
    c = info["exact_counts"]
    for fn in (fk.fused_sampler_cuda, sk.snis_fwd_cuda, sk.snis_bwd_cuda):
        check(c[f"{fn.__name__}.launches"] == DIST_STEPS,
              f"rank {rank}: {fn.__name__} launched {c[f'{fn.__name__}.launches']} times")
    check(all(v == 0 for k, v in c.items() if k.endswith(".calls")),
          f"rank {rank}: a plain version ran on the card: {c}")
    for t, r in enumerate(rec):
        out[f"exact/topk_scores{t}"] = r["topk"].scores.cpu().numpy()
        out[f"exact/topk_ids{t}"] = r["topk"].indices.cpu().numpy()
        out[f"exact/actions{t}"] = r["sample"].actions.cpu().numpy()
        out[f"exact/log_q{t}"] = r["sample"].log_q.cpu().numpy()
    r0 = rec[0]
    with torch.no_grad():
        scores0 = dist_scores(r0["h"], tr.beta, r0["sample"].actions, r0["sample"].log_q,
                              r0["rewards"], dist=d, sample_tile=TS)
    out["exact/h0"] = r0["h"].cpu().numpy()
    out["exact/rewards0"] = r0["rewards"].cpu().numpy()
    out["exact/scores0"] = scores0.cpu().numpy()
    slab = tr.beta.cpu().numpy()
    del tr, rec, r0
    torch.cuda.empty_cache()

    # the maintained route: ivf_pallas over this rank's shard of the index,
    # RefreshConfig()'s defaults, churn every CHURN_EVERY steps
    index = ShardedIVFIndex(*(torch.from_numpy(np.load(path / f"index_{f}.npy", mmap_mode="r"))
                              for f in ("centroids", "lists", "list_embs")), items.shape[0])
    churn = np.load(path / "churn.npz")
    rec = []
    tr = FOPOTrainer(dist_config(d, "ivf_pallas", index_refresh=RefreshConfig()), ds,
                     retriever_kwargs={"index": index}, **kw)
    tr.plan = step_recording_plan(tr.plan, rec, keep_state=(0, DIST_STEPS - 1))

    def churn_at(t):
        if t and t % CHURN_EVERY == 0:
            n = t // CHURN_EVERY - 1
            tr.update_items(torch.from_numpy(churn[f"ids{n}"]).to(dev),
                            torch.from_numpy(churn[f"embs{n}"]).to(dev))

    run(tr, DIST_STEPS, "maint", every=churn_at)
    c = info["maint_counts"]
    check(c["ivf_probe_topk_cuda.launches"] == 2 * DIST_STEPS,
          f"rank {rank}: ivf_topk launched {c['ivf_probe_topk_cuda.launches']} times in "
          f"{DIST_STEPS} steps (main + delta a step)")
    check(all(v == 0 for k, v in c.items() if k.endswith(".calls")),
          f"rank {rank}: a plain version ran on the card: {c}")
    # the two data replicas of this shard hold equal states
    sums = C.all_gather(state_checksum(tr.index_state)[None], d.data_group)
    check(bool((sums == sums[:1]).all()), f"rank {rank}: the data replicas' index states differ")
    # steps 1 and 20 again on the host: the plain K7 over this shard's state,
    # merged over the model group, against the card's merged top-K
    errs, k = [], tr.plan.cfg.top_k
    for t in (0, DIST_STEPS - 1):
        r = rec[t]
        st = RefreshState(*(x.cpu() for x in r["state"]))
        loc = iops.ivf_topk(r["h"].cpu(), st.as_index(items.shape[0]), k,
                            n_probe=DEFAULT_N_PROBE, delta=st.delta())
        top = merge_topk_along_axis(loc.scores, loc.indices, k, d.model_group)
        errs.append(topk_err((r["topk"].scores, r["topk"].indices),
                             (top.scores.to(dev), top.indices.to(dev)),
                             f"rank {rank} maintained step {t + 1} top-K vs the CPU replay"))
    info["maint_replay_err"] = max(errs)
    info["maint_overflow"] = int(tr.index_state.overflow)
    del tr, rec, index
    torch.cuda.empty_cache()

    # the guard: rank 3's gradients are NaN at step GUARD_AT; every rank skips it
    zero_counts()
    tr = FOPOTrainer(dist_config(d, health=HealthConfig()), ds,
                     fault_plan=FaultPlan(nan_grads_at=(GUARD_AT,)) if rank == 3 else None, **kw)
    verdicts = []
    for _ in range(GUARD_AT + 2):
        tr.train(1)
        verdicts.append(int(tr.guard_state.last_verdict))
        out.setdefault("guard/w", []).append(tr.params["w"].cpu().numpy())
    out["guard/w"] = np.stack(out["guard/w"])
    info["guard_verdicts"] = verdicts
    info["guard_counts"] = c = read_counts()
    check(all(v == 0 for k, v in c.items() if k.endswith(".calls")),
          f"rank {rank}: a plain version ran on the card: {c}")
    del tr
    torch.cuda.empty_cache()

    # sharded checkpoint: rank 0 writes beta in 4 shards, each rank reads
    # shard m of a 2-way split, which is its slab
    t0 = time.perf_counter()
    if rank == 0:
        save_sharded(str(path / "ckpt"), "beta", items, 4)
    tdist.barrier()
    got = restore_sharded(str(path / "ckpt"), "beta", shard_id=d.model_rank, num_shards=2)
    check(np.array_equal(got, slab), f"rank {rank}: the restored shard is not its slab")
    info["ckpt_s"] = time.perf_counter() - t0

    # int8 gradient compression over the world: a GraphCast-sized tree a rank
    comp = compression_drill(dev, 100 + rank)
    for key in ("q", "scale", "result"):
        for i, a in enumerate(comp.pop(key)):
            out[f"comp/{key}{i}"] = a
    info["comp"] = comp
    info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    info["rank_s"] = time.perf_counter() - t_rank
    np.savez(path / f"rank{rank}.npz", **out)
    (path / f"rank{rank}.json").write_text(json.dumps(info))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def dist_phase(ds, theta0) -> dict:
    """Multiple devices (phase 5f): drill A, the dist step on an NCCL
    world of one in this process against the single-device step; drill B,
    a gloo grid of four spawned ranks on the one card (NCCL refuses two
    ranks on one GPU), held to the single-device step replayed on the
    card."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch.dist.fopo import dist_scores, make_debug_dist
    from repro_torch.kernels.mips_topk.ops import mips_topk
    from repro_torch.kernels.snis_covgrad.ops import snis_scores_fused
    from repro_torch.mips.exact import TopK
    from repro_torch.mips.ivf import build_ivf_sharded
    from repro_torch.train import FOPOTrainer

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    card = card_line()
    seeds = np.random.default_rng(23).integers(0, 2**31 - 1, DIST_STEPS + GUARD_AT + 2)
    kw = dict(device=dev, params=theta0, step_seeds=lambda step: int(seeds[step]))
    lr = dist_config(None).learning_rate

    # drill A: NCCL, a world of one, against the single-device step
    t0 = time.perf_counter()
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                             world_size=1, rank=0)
    d1 = make_debug_dist(1, 1)
    ra, rb = [], []
    a = FOPOTrainer(dist_config(d1), ds, **kw)
    a.plan = step_recording_plan(a.plan, ra)
    zero_counts()
    ha = a.train(DIST_A_STEPS)
    counts_a = read_counts()
    b = FOPOTrainer(dist_config(None), ds, **kw)
    b.plan = step_recording_plan(b.plan, rb)
    hb, m_b = {"loss": []}, []
    for _ in range(DIST_A_STEPS):
        hb["loss"] += b.train(1)["loss"]
        m_b.append(b.opt_state["m"]["w"].clone())
    for t in range(DIST_A_STEPS):
        check(all(torch.equal(x, y) for x, y in zip(ra[t]["topk"], rb[t]["topk"])),
              f"drill A step {t}: the top-K differs")
        check(all(torch.equal(x, y) for x, y in zip(ra[t]["sample"], rb[t]["sample"])),
              f"drill A step {t}: the draws differ")
    r = ra[0]
    with torch.no_grad():
        s_dist = dist_scores(r["h"], a.beta, r["sample"].actions, r["sample"].log_q,
                             r["rewards"], dist=d1, sample_tile=TS)
        s_one = snis_scores_fused(rb[0]["h"], b.beta, rb[0]["sample"].actions,
                                  rb[0]["sample"].log_q, rb[0]["rewards"], sample_tile=TS)
    check(bool(torch.equal(s_dist, s_one)), "drill A: the sampled scores differ")
    close_err(torch.tensor(ha["loss"]), torch.tensor(hb["loss"]), "drill A loss", rtol=1e-6,
              atol=0.0)
    # the last step's gradient through Adam's first moment m = b1 m' + (1 - b1) g
    noisy_a = theta_gate(a.params["w"], b.params["w"], (m_b[-1] - 0.9 * m_b[-2]) / 0.1, lr,
                         "drill A theta")
    same_a = bool(torch.equal(a.params["w"], b.params["w"]))
    for fn in ("fused_sampler_cuda", "snis_fwd_cuda", "snis_bwd_cuda"):
        check(counts_a[f"{fn}.launches"] == DIST_A_STEPS, f"drill A: {fn} {counts_a}")
    check(all(v == 0 for k, v in counts_a.items() if k.endswith(".calls")),
          f"drill A: a plain version ran on the card: {counts_a}")
    comp_a = compression_drill(dev, 100)
    comp_a_err = compression_gate([comp_a], "drill A compression")
    tdist.destroy_process_group()
    secs_a = time.perf_counter() - t0
    del a, b, ra, rb, r
    torch.cuda.empty_cache()
    log(f"[dist] drill A: backend nccl, a world of one (data 1 x model 1) in this process: "
        f"{DIST_A_STEPS} steps of FOPOTrainer(fopo.dist) against the single-device trainer "
        f"from the same theta and step seeds: top-K and draws equal at every step, the step-1 "
        f"sampled scores equal bit for bit, losses within rtol 1e-6, theta "
        f"{'bit for bit equal' if same_a else f'by theta_gate ({noisy_a} noisy entries)'} "
        f"after {DIST_A_STEPS} steps; counts {counts_a}; {secs_a:.1f} s")
    log("[dist] drill A int8 compression (nccl; host ms are NCCL's enqueue): "
        + compression_line(comp_a, comp_a_err, 1))
    del comp_a

    # drill B: gloo, four ranks on the one card, data 2 x model 2
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dist_drill_"))
    try:
        beta = torch.from_numpy(ds.item_embeddings).to(dev)
        p = beta.shape[0]
        np.save(tmp / "items.npy", ds.item_embeddings)
        np.save(tmp / "contexts.npy", ds.contexts)
        np.save(tmp / "positives.npy", ds.positives)
        np.save(tmp / "theta0.npy", theta0["w"].cpu().numpy())
        np.save(tmp / "seeds.npy", seeds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        index = build_ivf_sharded(beta, 2, DIST_C, seed=0, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        for f in ("centroids", "lists", "list_embs"):
            np.save(tmp / f"index_{f}.npy", getattr(index, f).cpu().numpy())
        cap = index.lists.shape[2]
        del index
        gen = torch.Generator(device=dev).manual_seed(5)
        churn = {}
        for n in range(DIST_STEPS // CHURN_EVERY):
            ids = torch.randperm(p, generator=gen, device=dev)[:CHURN_ROWS]
            src = torch.randint(0, p, (CHURN_ROWS,), generator=gen, device=dev)
            noise = torch.randn((CHURN_ROWS, beta.shape[1]), generator=gen, device=dev)
            churn[f"ids{n}"] = ids.to(torch.int32).cpu().numpy()
            churn[f"embs{n}"] = (beta[src] + 0.05 * beta.std() * noise).cpu().numpy()
        np.savez(tmp / "churn.npz", **churn)
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        port = free_port()
        t1 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-rank",
                                   str(r), str(port), str(tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(4)]
        logs = ["" for _ in procs]
        try:
            deadline = time.perf_counter() + DIST_TIMEOUT_S
            while any(pr.poll() is None for pr in procs):
                if any(pr.poll() not in (None, 0) for pr in procs):
                    break  # a rank failed: the others would wait on it
                check(time.perf_counter() < deadline, "drill B: the ranks ran out of time")
                time.sleep(0.2)
        finally:
            for i, pr in enumerate(procs):
                if pr.poll() is None:
                    pr.kill()
                logs[i] = pr.communicate()[0]
        rcs = [pr.returncode for pr in procs]
        check(rcs == [0] * 4, f"drill B: rank exit codes {rcs}; their last lines:\n" + "\n".join(
            f"rank {i}: " + "\n".join(lg.strip().splitlines()[-12:]) for i, lg in enumerate(logs)))
        ranks_s = time.perf_counter() - t1
        outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
        infos = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the grid's records against the single-device step on the card: the
    # full batch is data rank 0's rows, then data rank 1's (model rank 0)
    def full(key):
        return torch.from_numpy(np.concatenate([outs[0][key], outs[2][key]])).to(dev)

    for key in outs[0]:  # model ranks 0 and 1 of a data rank hold equal merged results
        if key.startswith("exact/topk") or key.startswith("exact/scores0"):
            for dr in (0, 2):
                check(np.array_equal(outs[dr][key], outs[dr + 1][key]),
                      f"drill B: {key} differs between the model ranks")
    for tag in ("exact", "maint"):
        for r in range(1, 4):
            check(np.array_equal(outs[r][f"{tag}/w"], outs[0][f"{tag}/w"]),
                  f"drill B {tag}: theta differs between rank 0 and rank {r}")
    h0 = full("exact/h0")
    top0 = TopK(full("exact/topk_scores0"), full("exact/topk_ids0"))
    k6_err = topk_err(top0, mips_topk(h0, beta, top0.indices.shape[1]),
                      "drill B step 1 merged top-K vs mips_topk (K6) over the whole beta")
    with torch.no_grad():
        one = snis_scores_fused(h0, beta, full("exact/actions0"), full("exact/log_q0"),
                                full("exact/rewards0"), sample_tile=TS)
    check(bool(torch.equal(one, full("exact/scores0"))),
          "drill B: the step-1 sampled scores differ from the single-device K2's")
    # the single-device trainer replays the merged top-K, each step from rank
    # 0's theta and Adam state before it
    replay = [TopK(full(f"exact/topk_scores{t}"), full(f"exact/topk_ids{t}"))
              for t in range(DIST_STEPS)]
    rs: list = []
    one = FOPOTrainer(dist_config(None), ds, **kw)
    one.plan = step_recording_plan(one.plan, rs, replay=replay)
    w_dist, m_dist, v_dist = (torch.from_numpy(outs[0][f"exact/{k}"]) for k in ("w", "m", "v"))
    losses, noisy = [], []
    for t in range(DIST_STEPS):
        if t:
            one.params = {"w": w_dist[t - 1].to(dev)}
            one.opt_state = {"step": one.opt_state["step"], "m": {"w": m_dist[t - 1].to(dev)},
                             "v": {"w": v_dist[t - 1].to(dev)}}
        losses += one.train(1)["loss"]
        check(torch.equal(rs[t]["sample"].actions, full(f"exact/actions{t}")),
              f"drill B step {t + 1}: the draws differ from the single-device K5's")
        m_prev = m_dist[t - 1] if t else torch.zeros_like(m_dist[0])
        noisy.append(theta_gate(one.params["w"], w_dist[t], (m_dist[t] - 0.9 * m_prev) / 0.1,
                                lr, f"drill B step {t + 1} theta"))
    close_err(torch.tensor(losses), torch.from_numpy(outs[0]["exact/loss"]), "drill B loss",
              rtol=1e-5, atol=0.0)
    del one, rs, replay, beta
    torch.cuda.empty_cache()
    gw = outs[0]["guard/w"]
    for r in range(4):
        v = infos[r]["guard_verdicts"]
        check(v[GUARD_AT] != 0 and all(x == 0 for i, x in enumerate(v) if i != GUARD_AT),
              f"drill B guard: rank {r} verdicts {v}")
        check(np.array_equal(outs[r]["guard/w"], gw), f"drill B guard: theta of rank {r} differs")
    check(np.array_equal(gw[GUARD_AT], gw[GUARD_AT - 1]), "drill B guard: step not skipped")
    check(not np.array_equal(gw[GUARD_AT + 1], gw[GUARD_AT]), "drill B guard: no step after it")

    # the compression drill: every rank's result against the formula
    drills = [dict(**i["comp"], **{key: [o[f"comp/{key}{j}"] for j in range(
        sum(1 for k in o if k.startswith("comp/q")))] for key in ("q", "scale", "result")})
        for i, o in zip(infos, outs)]
    t0 = time.perf_counter()
    comp_b_err = compression_gate(drills, "drill B compression")
    log("[dist] drill B int8 compression (gloo through the host, rank 0's STATS): "
        + compression_line(drills[0], comp_b_err, 4)
        + "; the ranks' drills " + ", ".join(f"{d['drill_s']:.1f}" for d in drills)
        + f" s, the gate on the CPU {time.perf_counter() - t0:.1f} s")
    del drills

    counts = {}
    for c in [counts_a] + [i[f"{tag}_counts"] for i in infos for tag in ("exact", "maint",
                                                                         "guard")]:
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 1e9
    secs = time.perf_counter() - t_phase
    coll = infos[0]["exact_collectives"]
    log(f"[dist] drill B: backend {infos[0]['backend']} (NCCL refuses two ranks on one GPU), "
        f"four spawned ranks on the one card, data 2 x model 2: slabs of {p // 2} rows "
        f"({p // 2 * ds.item_embeddings.shape[1] * 4 / 1e6:.0f} MB), "
        f"{dist_config(None).batch_size // 2} batch rows a data rank; setup {setup_s:.1f} s "
        f"(files, build_ivf_sharded C {DIST_C} a shard, cap {cap}: {build_s:.1f} s), ranks "
        f"{ranks_s:.1f} s (each from start to exit: "
        + ", ".join(f"{i['rank_s']:.1f}" for i in infos) + " s)")
    log("[dist] drill B exact route (the sharded streaming top-K, K5 at row offsets 0 and "
        f"{dist_config(None).batch_size // 2}, K2 / K4 on the slabs): {DIST_STEPS} steps; step "
        "p50 by rank "
        + ", ".join(f"{i['exact_p50_ms']:.2f}" for i in infos)
        + f" ms; merged top-K equal on the model ranks, step 1's against K6 over the whole "
        f"beta (max score diff {k6_err:.3g}); the step-1 sampled scores equal the single-device "
        f"K2's bit for bit; the single-device trainer on the card, on the merged top-K, draws "
        f"the same actions at every step, losses within rtol 1e-5, theta by theta_gate "
        f"({noisy} noisy entries a step); theta bit for bit equal on all four ranks")
    log("[dist] drill B exact route, rank 0's collectives a step (gloo through one card's "
        "host; not a measure of NCCL): " + "; ".join(
            f"{k} {v['calls_per_step']:.0f} call(s) {v['bytes_per_step'] / 1e3:.1f} kB "
            f"{v['ms_per_step']:.2f} ms" for k, v in coll.items()))
    log(f"[dist] drill B maintained route (ivf_pallas, build_ivf_sharded C {DIST_C}, "
        f"RefreshConfig() defaults, {CHURN_ROWS} rows churned every {CHURN_EVERY} steps): "
        f"{DIST_STEPS} steps; step p50 by rank "
        + ", ".join(f"{i['maint_p50_ms']:.2f}" for i in infos)
        + f" ms; ivf_topk 2 launches a step on every rank, no plain version; the data "
        f"replicas' index states equal; steps 1 and {DIST_STEPS} merged top-K against the "
        f"CPU replay of the plain K7 over the shards' states (max score diff "
        f"{max(i['maint_replay_err'] for i in infos):.3g}); overflow "
        + ", ".join(str(i["maint_overflow"]) for i in infos))
    log(f"[dist] drill B guard: NaN gradients on rank 3 at step {GUARD_AT + 1}: the agreed "
        f"verdict nonzero on every rank, every rank skipped, theta bit for bit equal; "
        f"checkpoint: save_sharded wrote beta in 4 shards, restore_sharded gave each rank its "
        f"slab of a 2-way split bit for bit (" + ", ".join(f"{i['ckpt_s']:.2f}" for i in infos)
        + " s)")
    log(f"[dist] phase 5f took {secs:.1f} s; peak device memory: this process {peak:.2f} GB, "
        "ranks " + ", ".join(f"{i['peak_gb']:.2f}" for i in infos) + f" GB; {card}; "
        f"launches {counts}")
    return dict(counts=counts, secs=secs)


# ---------------------------------------------------------------------------
# 12. the dry run against the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def cell_cut(arch: str, shape: str, cell_kw=None, cfg_kw=None):
    """The arch's ``shape`` cell and its config with fields replaced while
    the block runs (`launch.specs` reads both from the config module)."""
    from repro_torch.configs import get_arch

    mod = get_arch(arch)
    shapes, cfg = mod.SHAPES, mod.CONFIG
    mod.SHAPES = {**shapes, shape: dataclasses.replace(shapes[shape], **(cell_kw or {}))}
    mod.CONFIG = dataclasses.replace(cfg, **(cfg_kw or {}))
    try:
        yield
    finally:
        mod.SHAPES, mod.CONFIG = shapes, cfg


def real_args(prog, dev, seed: int) -> tuple:
    """Real tensors on ``dev`` for a cell program's abstract arguments:
    matrices N(0, 1 / fan_in) and vectors 0 for the parameters, the
    optimizer's state 0, valid token / item ids, normal features, a
    GNN's last 5 % of edges padded with -1 and its loss mask 1."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import tree_map_with_path

    gen = torch.Generator(device=dev).manual_seed(seed)
    family = get_arch(prog.arch_id).FAMILY

    def zeros(x):
        return torch.zeros(x.shape, dtype=x.dtype, device=dev) if torch.is_tensor(x) else x

    def param(_, x):
        if x.dim() < 2:
            return zeros(x)
        w = torch.randn(x.shape, generator=gen, device=dev) / math.sqrt(x.shape[-2])
        return w.to(x.dtype)

    def ids(x, hi: int, lo: int = 0):
        return torch.randint(lo, hi, x.shape, generator=gen, device=dev, dtype=x.dtype)

    params = tree_map_with_path(param, prog.args[0])
    rest = list(prog.args[1:])
    out = [params]
    if prog.donate_argnums == (0, 1):  # a train step: the optimizer's state
        out.append(tree_map_with_path(lambda _, x: zeros(x), rest.pop(0)))
    if family == "lm":
        vocab = params["embed"].shape[0]
        out += [ids(x, vocab) if torch.is_tensor(x) and x.dim() == 2 else
                tree_map_with_path(lambda _, y: zeros(y), x) for x in rest]
    elif family == "gnn":
        feats, src, dst, targets, mask = rest
        n = feats.shape[0]
        edges = [ids(src, n), ids(dst, n)]
        for e in edges:
            e[-(e.shape[0] // 20):] = -1
        out += [torch.randn(feats.shape, generator=gen, device=dev), *edges,
                torch.randn(targets.shape, generator=gen, device=dev),
                torch.ones(mask.shape, device=dev)]
    else:
        items = params["items"].shape[0]
        out += [{k: ids(x, items) if not x.dtype.is_floating_point else
                 torch.randn(x.shape, generator=gen, device=dev) for k, x in batch.items()}
                for batch in rest]
    return tuple(out)


def local_leaves(tree) -> list:
    """The tensors of an output tree, a DTensor as its local tensor."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if torch.is_tensor(t)]


def diff_and_scale(x, y, chunk: int = 1 << 24) -> tuple[float, float]:
    """(max |x - y|, max |y|) in fp64, a chunk at a time: the outputs of
    two training steps are on the card already."""
    xf, yf = x.reshape(-1), y.reshape(-1)
    d = scale = 0.0
    for i in range(0, xf.numel(), chunk):
        a, b = xf[i:i + chunk].double(), yf[i:i + chunk].double()
        d = max(d, (a - b).abs().max().item())
        scale = max(scale, b.abs().max().item())
    return d, scale


def outputs_gate(got, want, tag: str, lr: float | None, low_precision: bool = False) -> dict:
    """The DTensor run's outputs against the plain run's, leaf by leaf:
    bitwise equal, or within fp32 rtol 1e-5 of the leaf's largest
    magnitude (+ 1e-6), bf16 one ulp of it; a train step's parameters
    within 2 lr (Adam's first step moves an entry by about lr whatever
    its gradient, so a gradient that differs in its last bits, from
    atomic adds or a GQA group summed in another order, moves it by up to
    2 lr; 2^-7 more where g * g is rounded to bf16) and its moments
    within 1e-2 of the leaf's largest, 2^-5 with ``low_precision`` (bf16
    parameters in, whose gradients are sums of bf16 terms, rounded in
    another order by the atomic adds and by the KV repeat's backward,
    which sums a GQA group in bf16 where K10 sums it in fp32). Returns the
    largest difference,
    how many leaves were bitwise equal and the leaves past their
    tolerance."""
    import torch

    a, b = local_leaves(got), local_leaves(want)
    check(len(a) == len(b), f"[dryrun] {tag}: {len(a)} outputs against {len(b)}")
    worst, same, bad = 0.0, 0, []
    n_params = len(a) // 3 if lr is not None else 0  # (params, {step, m, v}, loss)
    for i, (x, y) in enumerate(zip(a, b)):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"[dryrun] {tag}: output {i} {tuple(x.shape)} {x.dtype} against "
              f"{tuple(y.shape)} {y.dtype}")
        if torch.equal(x, y):
            same += 1
            continue
        d, scale = diff_and_scale(x, y)
        if lr is not None and i < n_params:
            tol = 2 * lr * (1 + 2.0**-7)  # |u| = |g| / sqrt(v): v from bf16(g * g) in bf16
        elif lr is not None and i < len(a) - 1:
            tol = (2.0**-5 if low_precision else 1e-2) * scale
        elif y.dtype == torch.bfloat16:
            tol = BF16_RTOL * scale
        else:
            tol = RTOL * scale + ATOL
        if d > tol:
            bad.append(f"output {i} {tuple(y.shape)} differs by {d:.3e} (tolerance {tol:.3e})")
        worst = max(worst, d)
    return {"max_abs_diff": worst, "bitwise_leaves": same, "leaves": len(a), "failed": bad}


def held_cell(mesh, dev, tag: str, arch: str, shape: str, opt: bool, lr=None,
              seed: int = 0) -> dict:
    """One cell on the card's 1 x 1 mesh (phase 12a): the DTensor step run
    for real under the op walker (max_memory_allocated, the kernels'
    launches), the dry run of the same program (FLOPs equal, peak within
    DRY_MEM_REL + DRY_MEM_ABS), one untimed-walker step for its time, and
    the plain step on the same tensors (outputs within `outputs_gate`)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.flash_attention import kernel as flk
    from repro_torch.launch import dryrun, jaxpr_cost, specs

    t_cell = time.perf_counter()
    prog = specs.build_program(arch, shape, opt=opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    args = real_args(prog, dev, seed)
    dargs = specs.distribute(mesh, args, prog.in_specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flk.flash_attention_fwd_cuda.launches = flk.flash_attention_bwd_cuda.launches = 0
    r = jaxpr_cost.analyze(prog.fn, *dargs)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd_cuda.launches": flk.flash_attention_fwd_cuda.launches,
                "flash_attention_bwd_cuda.launches": flk.flash_attention_bwd_cuda.launches}
    card_peak = torch.cuda.max_memory_allocated() - m0
    out_d = r.pop("out")
    if shape.startswith("prefill"):  # the cache is written in place: keep the DTensor run's
        out_d = (out_d[0], [t.to_local().clone() for t in (out_d[1].k, out_d[1].v)])
    row = dryrun.run_cell(arch, shape, multi_pod=False, opt=opt, mesh=mesh)
    pred = row["memory"]["peak_bytes"]
    # the step's time without the walker (one eager call, host work included;
    # the plain tensors the step makes replicated over the mesh, as `analyze` does)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with implicit_replication():
        out_t = prog.fn(*dargs)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del out_t, dargs
    torch.cuda.empty_cache()
    # the plain step on the same tensors
    out_p = prog.fn(*args)
    if shape.startswith("prefill"):
        out_p = (out_p[0], [out_p[1].k, out_p[1].v])
    bf16_in = any(t.dtype == torch.bfloat16 for t in local_leaves(args[0]))
    gate = outputs_gate(out_d, out_p, tag, lr, low_precision=bf16_in)
    del out_p, out_d, args
    torch.cuda.empty_cache()
    rf = row["roofline"]
    res = {"flops": r["flops"], "bytes": r["bytes"], "predicted_peak_bytes": pred,
           "card_peak_bytes": card_peak, "step_s": step_s,
           "bound_s": rf["step_time_lower_bound_s"], "dominant": rf["dominant"],
           "useful_flops_ratio": row["useful_flops_ratio"], "kernel_ops": r["kernel_ops"],
           "launches": launches, "traced_at": row["traced_at"], **gate,
           "seconds": time.perf_counter() - t_cell}
    log(f"[dryrun] {tag}: FLOPs {r['flops']:.6e} (dry run = walker over the card's step), "
        f"bytes {r['bytes']:.6e}; peak predicted {pred / 1e9:.3f} GB, card "
        f"{card_peak / 1e9:.3f} GB ({(pred - card_peak) / card_peak * 100:+.2f} %); step "
        f"{step_s * 1e3:.2f} ms against a bound of {rf['step_time_lower_bound_s'] * 1e3:.4f} ms "
        f"({rf['dominant']}), useful FLOPs {row['useful_flops_ratio']:.4f}; kernel ops "
        f"{r['kernel_ops']}, launches {launches}; outputs against the plain step: "
        f"{gate['bitwise_leaves']}/{gate['leaves']} bitwise, max |diff| "
        f"{gate['max_abs_diff']:.3e} ({res['seconds']:.1f} s)")
    check(row["hlo_flops"] == r["flops"],
          f"[dryrun] {tag}: the dry run counts {row['hlo_flops']} FLOPs, the walker over the "
          f"card's step {r['flops']}")
    check(abs(pred - card_peak) <= DRY_MEM_REL * card_peak + DRY_MEM_ABS,
          f"[dryrun] {tag}: predicted peak {pred / 1e9:.3f} GB, the card's "
          f"{card_peak / 1e9:.3f} GB")
    check(not gate["failed"], f"[dryrun] {tag}: {'; '.join(gate['failed'][:5])}")
    return res


def train_layers_that_fit(mesh, arch: str, shape: str, full: int) -> tuple[int, dict]:
    """The most layers (even: Gemma-2 alternates local and global layers)
    at which the dry run's peak of the training cell plus its outputs
    (kept beside the plain run's) fit within DRY_TRAIN_FIT bytes, from the
    dry run at 2 layers and at the full depth (its need is affine in the
    layers)."""
    from repro_torch.launch import dryrun

    def need(layers):
        with cell_cut(arch, shape, cfg_kw=dict(num_layers=layers)):
            row = dryrun.run_cell(arch, shape, multi_pod=False, opt=True, mesh=mesh)
        m = row["memory"]
        return m["peak_bytes"] + m["output_bytes"] - m["alias_bytes"]

    lo, hi = need(2), need(full)
    per = (hi - lo) / (full - 2)
    layers = full if hi <= DRY_TRAIN_FIT else 2 + 2 * int((DRY_TRAIN_FIT - lo) / per // 2)
    return max(2, min(full, layers)), {"need_2": lo, f"need_{full}": hi}


def flash_host_us(dev) -> dict:
    """Host µs a call of K9 through the registered operator
    (`ops.flash_attention_fwd`) against its ctypes wrapper alone
    (`kernel.flash_attention_fwd_cuda`), launched back to back at a small
    shape (B 1, S 128, H 8, KV 4, D 64, bf16) so the host is the limit."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flk
    from repro_torch.kernels.flash_attention import ops as fops

    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 128, 8, 64), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((1, 128, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    out = {}
    for name, fn in (("registered_op", lambda: fops.flash_attention_fwd(q, k, k)),
                     ("ctypes_wrapper", lambda: flk.flash_attention_fwd_cuda(q, k, k))):
        best = float("inf")
        for _ in range(3):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            best = min(best, (time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        out[name] = best
    return out


def dryrun_phase() -> dict:
    """Phase 12: (a) four cell programs on a real NCCL group of one rank
    (DTensor on a 1 x 1 mesh), each run on the card and dry-run at the
    same mesh and shapes, held to each other (`held_cell`); (b) three
    production cells dry-run on the 256-rank pod mesh on the card's host."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    out = {"host_us": flash_host_us(dev)}
    h = out["host_us"]
    log(f"[dryrun] K9's host cost a call: {h['registered_op']:.2f} us through the registered "
        f"operator, {h['ctypes_wrapper']:.2f} us through its ctypes wrapper alone "
        f"({h['registered_op'] - h['ctypes_wrapper']:+.2f} us)")
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                             world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cells = {}
        cells["graphcast molecule"] = held_cell(mesh, dev, "graphcast molecule", "graphcast",
                                                "molecule", False, lr=1e-4)
        cells["sasrec serve_p99"] = held_cell(mesh, dev, "sasrec serve_p99", "sasrec",
                                              "serve_p99", False)
        with cell_cut("gemma2-2b", "prefill_32k", cell_kw=dict(global_batch=1)):
            cells["gemma2-2b prefill_32k opt B 1"] = held_cell(
                mesh, dev, "gemma2-2b prefill_32k --opt, global batch 1", "gemma2-2b",
                "prefill_32k", True)
        full = get_arch("gemma2-2b").CONFIG.num_layers
        with cell_cut("gemma2-2b", "train_4k", cell_kw=dict(global_batch=1)):
            layers, need = train_layers_that_fit(mesh, "gemma2-2b", "train_4k", full)
            log(f"[dryrun] gemma2-2b train_4k --opt, global batch 1: {layers} of {full} layers "
                f"(the dry run's peak plus outputs {need['need_2'] / 1e9:.2f} GB at 2 layers, "
                f"{need[f'need_{full}'] / 1e9:.2f} GB at {full}; limit "
                f"{DRY_TRAIN_FIT / 1e9:.0f} GB, both runs' outputs held at once)")
            with cell_cut("gemma2-2b", "train_4k", cfg_kw=dict(num_layers=layers)):
                cells["gemma2-2b train_4k opt B 1"] = held_cell(
                    mesh, dev, f"gemma2-2b train_4k --opt, global batch 1, {layers} layers",
                    "gemma2-2b", "train_4k", True, lr=1e-4)
        cells["gemma2-2b train_4k opt B 1"].update(layers=layers, **need)
    finally:
        tdist.destroy_process_group()
    pre, tr = cells["gemma2-2b prefill_32k opt B 1"], cells["gemma2-2b train_4k opt B 1"]
    n_pre = get_arch("gemma2-2b").CONFIG.num_layers
    check(pre["launches"]["flash_attention_fwd_cuda.launches"] == n_pre,
          f"[dryrun] the prefill launched K9 {pre['launches']} times ({n_pre} layers)")
    check(tr["launches"] == {"flash_attention_fwd_cuda.launches": tr["layers"],
                             "flash_attention_bwd_cuda.launches": tr["layers"]},
          f"[dryrun] the training step launched {tr['launches']} ({tr['layers']} layers)")
    check(pre["kernel_ops"] == {"flash_attention_fwd": n_pre}
          and tr["kernel_ops"] == {"flash_attention_fwd": tr["layers"],
                                   "flash_attention_bwd": tr["layers"]},
          "[dryrun] the walker did not cost K9 / K10 once a layer")
    out["cells"] = cells
    # 12b. production cells on the pod mesh
    prod = {}
    for arch, shape, opt in (("gemma2-2b", "train_4k", False), ("gemma2-2b", "train_4k", True),
                             ("sasrec", "train_batch", False)):
        row = dryrun.run_cell(arch, shape, multi_pod=False, opt=opt)
        check(row["ok"] and not tdist.is_initialized(), f"[dryrun] {arch} {shape} opt={opt}")
        rf, m = row["roofline"], row["memory"]
        tag = f"{arch} {shape} {'opt' if opt else 'baseline'}"
        prod[tag] = {"trace_s": row["trace_s"], "peak_bytes": m["peak_bytes"],
                     "bound_s": rf["step_time_lower_bound_s"], "dominant": rf["dominant"],
                     "kernel_ops": row["kernel_ops"]}
        log(f"[dryrun] {tag} on the pod mesh (256 ranks): ok, traced in {row['trace_s']} s at "
            f"{row['traced_at']}; per-device peak {m['peak_bytes'] / 1e9:.2f} GB; bound "
            f"{rf['step_time_lower_bound_s'] * 1e3:.3f} ms ({rf['dominant']}); kernel ops "
            f"{row['kernel_ops']}")
    check(prod["gemma2-2b train_4k opt"]["kernel_ops"].get("flash_attention_bwd", 0) > 0,
          "[dryrun] the opt training cell costed no K10")
    out["production"] = prod
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase 12 took {out['seconds']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# 13. the step's bytes through the op walker, K1-K8 as registered operators
# ---------------------------------------------------------------------------

# the walker's bytes of a fopo-paper step over the byte model's, by route
# (PERF.md section 6 explains each band): on pallas beta is read twice, as
# the step's argument and by K6's pass, where the model reads it once; on
# ivf_pallas beta's argument alone is 5.1x the model, K7's rule charges
# every slot of the 8 probed lists of capp 2048 (the model: 2 lists of
# twice the mean size)
STEP_BYTES_BAND = {"pallas": (1.95, 2.05), "ivf_pallas": (8.0, 10.5)}
HOST_CALLS = 1200  # calls of each op and of its ctypes wrapper timed on the host


def op_kernels() -> dict:
    """{op name: (the kernel's ctypes wrapper, its plain version)} of K1-K8."""
    from repro_torch.kernels.embedding_bag import kernel as ek, ref as er
    from repro_torch.kernels.fused_sampler import kernel as fk, ref as fr
    from repro_torch.kernels.ivf_topk import kernel as ik, ref as ir
    from repro_torch.kernels.mips_topk import kernel as mk, ref as mr
    from repro_torch.kernels.snis_covgrad import kernel as sk, ref as sr

    return {"mips_topk": (mk.mips_topk_cuda, mr.mips_topk_ref),
            "ivf_probe_topk": (ik.ivf_probe_topk_cuda, ir.ivf_probe_topk_ref),
            "fused_sampler": (fk.fused_sampler_cuda, fr.fused_sampler_ref),
            "snis_covgrad_fwd": (sk.snis_fwd_cuda, sr.snis_fwd_ref),
            "snis_covgrad_bwd": (sk.snis_bwd_cuda, sr.snis_bwd_ref),
            "embedding_bag": (ek.embedding_bag_cuda, er.embedding_bag_ref)}


def direct_call(name: str, args: tuple):
    """The op's call on its ctypes wrapper alone, with the op's arguments."""
    fn = op_kernels()[name][0]
    if name == "snis_covgrad_fwd":
        return fn(*args[:5], covgrad=args[5])
    if name == "fused_sampler":
        seed, eps, ids, scores, s, p, ts, off = args
        return fn(seed, eps, ids, scores, num_samples=s, num_items=p, sample_tile=ts,
                  row_offset=off)
    return fn(*args)


@contextlib.contextmanager
def recorded_kernel_terms(record: list):
    """While active, every kernel op the walker costs is appended to
    ``record`` as (name, args, outputs, bytes of its rule)."""
    from repro_torch.launch import jaxpr_cost as pc

    saved = dict(pc.KERNEL_RULES)
    for name, rule in saved.items():
        def wrapped(args, out, name=name, rule=rule):
            cost = rule(args, out)
            record.append((name, args, out, cost[1]))
            return cost

        pc.KERNEL_RULES[name] = wrapped
    try:
        yield
    finally:
        pc.KERNEL_RULES.update(saved)


def data_bound_bytes(name: str, args: tuple, out) -> float:
    """The bytes one kernel call must move for its data: its work function
    fed this call's counts (distinct rows gathered, kappa-arm draws, live
    list slots, distinct live bag rows)."""
    import torch

    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.fused_sampler import kernel as fk
    from repro_torch.kernels.ivf_topk import kernel as ik
    from repro_torch.kernels.mips_topk import kernel as mk
    from repro_torch.kernels.snis_covgrad import kernel as sk

    if name == "snis_covgrad_fwd":
        h, beta, a, _, _, cg = args
        return sk.snis_fwd_work(h.shape[0], a.shape[1], h.shape[1], beta.shape[0], cg,
                                rows=torch.unique(a.clamp(min=0)).numel())[2]
    if name == "snis_covgrad_bwd":
        cf, a, beta = args
        return sk.snis_bwd_work(*cf.shape, beta.shape[1], beta.shape[0],
                                rows=torch.unique(a[a >= 0]).numel())[2]
    if name == "fused_sampler":
        _, _, ids, _, s, _, ts, _ = args
        return fk.sampler_work(ids.shape[0], s, -(-s // ts) * ts, ids.shape[1],
                               kappa_draws=int((out[2] >= 0).sum()))[2]
    if name == "mips_topk":
        q, items, k = args
        return mk.mips_topk_work(q.shape[0], *items.shape, k)[2]
    if name == "ivf_probe_topk":
        q, probe, lists, _, k = args
        return ik.ivf_probe_work(*q.shape, probe.shape[1], lists.shape[1], k,
                                 live=ivf_live(probe, lists))[2]
    table, idx = args
    rows, live = eb_counts(table, idx)
    return ek.embedding_bag_work(*idx.shape, *table.shape, table.element_size(), rows=rows,
                                 live=live)[2]


def walked_run(fn, args: tuple, expected: dict, tag: str) -> tuple[dict, list]:
    """``fn(*args)`` on the card under the op walker with every K1-K8 counter
    set to 0 just before and read just after: the walker's kernel ops must
    equal the launch counters' deltas and ``expected``, and no plain
    version may run. Returns (`analyze`'s result, the recorded kernel
    terms)."""
    import torch

    from repro_torch.launch import jaxpr_cost as pc

    kernels = op_kernels()
    for kern, plain in kernels.values():
        kern.launches, plain.calls = 0, 0
    rec: list = []
    with recorded_kernel_terms(rec):
        r = pc.analyze(fn, *args)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, (k, _) in kernels.items() if k.launches}
    plain = {n: p.calls for n, (_, p) in kernels.items() if p.calls}
    check(r["kernel_ops"] == launches == expected,
          f"{tag}: walker kernel ops {r['kernel_ops']}, launches {launches}, expected {expected}")
    check(not plain, f"{tag}: plain versions ran on the card: {plain}")
    return r, rec


def term_ratios(rec: list, tag: str) -> dict:
    """Each kernel op's term (its rule, shape-only) over the bytes its data
    needs; fails where a term falls below them."""
    out = {}
    for name, args, res, nb in rec:
        bound = data_bound_bytes(name, args, res)
        check(nb >= bound, f"{tag}: {name}'s term {nb} is below its data's {bound} bytes")
        out[name] = nb / bound
    return out


def host_us(fns: list, calls: int = HOST_CALLS) -> list[float]:
    """Median host us of one call of each of ``fns``, each call timed
    alone, the functions taking turns (so a drift of the host's speed
    reaches all alike); the card is drained every 4 turns, not timed, so
    no launch waits on a full queue."""
    import torch

    for _ in range(20):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    ts = [[] for _ in fns]
    for i in range(calls):
        for fn, t in zip(fns, ts):
            t0 = time.perf_counter_ns()
            fn()
            t.append((time.perf_counter_ns() - t0) / 1e3)
        if i % 4 == 3:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return [percentile(t, 50) for t in ts]


def op_costs(name: str, args: tuple) -> dict:
    """One op at its main-path arguments: host µs a call through the
    registered operator and through its ctypes wrapper, and device ms a
    call of both captured in a CUDA graph; the capture must run the op's
    body (its launch counter moves once a captured call)."""
    import torch

    op = getattr(torch.ops.repro_torch, name).default
    kern = op_kernels()[name][0]
    res = dict(zip(("op_host_us", "wrapper_host_us"),
                   host_us([lambda: op(*args), lambda: direct_call(name, args)])))
    before = kern.launches
    res["op_graph_ms"] = device_ms(lambda: op(*args), [()], calls=8, replays=4)
    check(kern.launches - before == 9, f"{name}: the graph capture ran the op's body "
          f"{kern.launches - before} times, not 9 (a warm-up and 8 captured)")
    res["wrapper_graph_ms"] = device_ms(lambda: direct_call(name, args), [()], calls=8, replays=4)
    return res


def step_bytes_phase(ds, theta0, tres: dict) -> dict:
    """Phase 13: one fopo-paper step at full width (P 750,000, L 100, S
    1000, K 256, B 32; fused, fused_sampler, TS 8) on the pallas and the
    ivf_pallas routes under the op walker, on the card and on meta
    tensors; K8 once at the DLRM bag shape; each K1-K8 op's host and
    graph costs against its ctypes wrapper."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import ExecutionPlan, SoftmaxPolicy
    from repro_torch.core.policy import linear_tower_apply
    from repro_torch.core.rewards import make_session_reward
    from repro_torch.kernels.embedding_bag import ops as eo
    from repro_torch.launch import jaxpr_cost as pc
    from repro_torch.mips.ivf import IVFIndex, build_ivf
    from repro_torch.obs.drift import jaxpr_step_bytes, predict_step_bytes
    from repro_torch.optim.optimizers import value_and_grad

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    paper = get_arch("fopo-paper").CONFIG
    b, l = paper.batch_size, paper.embed_dim
    policy = SoftmaxPolicy(tower=linear_tower_apply, item_dim=l)

    def step_of(plan):
        def step(w, x, beta, pos):
            return value_and_grad(lambda prm: plan.execute(
                policy, prm, 7, x, beta, make_session_reward(pos))[0], {"w": w})
        return step

    args = (theta0["w"].to(dev), torch.from_numpy(ds.contexts[:b]).to(dev),
            torch.from_numpy(ds.item_embeddings).to(dev),
            torch.from_numpy(ds.positives[:b]).to(dev))
    margs = tuple(torch.empty_like(t, device="meta") for t in args)
    index = build_ivf(args[2], seed=0, device=dev)
    meta_index = IVFIndex(*(torch.empty_like(t, device="meta") for t in index[:3]),
                          index.num_items)
    res, costs = {}, {}
    for route in ("pallas", "ivf_pallas"):
        fopo = dataclasses.replace(paper.fopo, retriever=route, fused=True, fused_sampler=True,
                                   sample_tile=TS)
        kw = mkw = None
        if route == "ivf_pallas":
            kw, mkw = {"index": index, "n_probe": N_PROBE}, {"index": meta_index,
                                                              "n_probe": N_PROBE}
        plan, mplan = (ExecutionPlan.resolve(fopo, retriever_kwargs=k) for k in (kw, mkw))
        retrieval = "mips_topk" if route == "pallas" else "ivf_probe_topk"
        expected = {retrieval: 1, "fused_sampler": 1, "snis_covgrad_fwd": 1,
                    "snis_covgrad_bwd": 1}
        r, rec = walked_run(step_of(plan), args, expected, f"step bytes {route}")
        loss, grads = r["out"]
        check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grads["w"]).all())
              and grads["w"].shape == (l, l), f"step bytes {route}: a non-finite step")
        m = pc.analyze(step_of(mplan), *margs)
        same = (m["bytes"], m["flops"], m["kernel_ops"]) == (r["bytes"], r["flops"],
                                                             r["kernel_ops"])
        check(same, f"step bytes {route}: meta {m['bytes']} B / {m['flops']} FLOPs / "
              f"{m['kernel_ops']}, card {r['bytes']} / {r['flops']} / {r['kernel_ops']}")
        ratios = term_ratios(rec, f"step bytes {route}")
        jb = jaxpr_step_bytes(step_of(mplan), *margs)
        pred = predict_step_bytes(plan, b, l)["total_bytes"]
        lo, hi = STEP_BYTES_BAND[route]
        check(jb == float(r["bytes"]) and lo <= jb / pred <= hi,
              f"step bytes {route}: jaxpr_step_bytes {jb} over predict_step_bytes {pred} = "
              f"{jb / pred:.4f}, outside [{lo}, {hi}]")
        terms = {name: nb for name, _, _, nb in rec}
        log(f"[step-bytes] {route}: kernel ops {r['kernel_ops']} = the launch counters' "
            f"deltas, no plain version; the meta trace equals the card's exactly ({r['bytes']} "
            f"bytes, {r['flops']} FLOPs); jaxpr_step_bytes {jb:.0f} beside predict_step_bytes "
            f"{pred} = {jb / pred:.4f} (band [{lo}, {hi}]); kernel terms (bytes) {terms}, each "
            "over its data's bound: " + ", ".join(f"{n} {v:.4f}" for n, v in ratios.items()))
        if route == "ivf_pallas":
            c, capp = index.lists.shape
            log(f"[step-bytes] ivf_pallas index: C {c}, capp {capp}, n_probe {N_PROBE}")
        res[route] = dict(bytes=r["bytes"], flops=r["flops"], kernel_ops=r["kernel_ops"],
                          jaxpr_step_bytes=jb, predict_step_bytes=pred, ratio=jb / pred,
                          term_over_data_bound=ratios, terms=terms)
        for name, a, _, _ in rec:
            if name not in costs:
                costs[name] = op_costs(name, a)
        del plan, mplan, r, m, rec
    del index
    torch.cuda.empty_cache()

    # K8 through its op once, at phase 6's DLRM bag shape
    v, d, bags, t = 40_000_000, 128, 4096, 100
    gen = torch.Generator(device=dev).manual_seed(31)
    table = torch.randn((v, d), generator=gen, device=dev)
    idx = dlrm_bags(bags, t, v, gen, full=False)
    r, rec = walked_run(lambda tb, ix: eo.embedding_bag(tb, ix), (table, idx),
                        {"embedding_bag": 1}, "step bytes K8")
    check(torch.equal(r["out"], op_kernels()["embedding_bag"][0](table, idx)),
          "K8 under the walker differs from its ctypes wrapper")
    res["embedding_bag"] = dict(bytes=r["bytes"], term_over_data_bound=term_ratios(
        rec, "step bytes K8"), terms={rec[0][0]: rec[0][3]})
    costs["embedding_bag"] = op_costs("embedding_bag", rec[0][1])
    log(f"[step-bytes] K8 at the DLRM bag shape (40,000,000 x 128 fp32, B 4096, T 100 "
        f"ragged): kernel ops {{'embedding_bag': 1}} = its launch counter's delta, no plain "
        f"version; term {rec[0][3]} bytes, "
        f"{res['embedding_bag']['term_over_data_bound']['embedding_bag']:.4f}x its data's "
        "bound; bitwise the ctypes wrapper's sum")
    del table, idx, r, rec
    torch.cuda.empty_cache()
    for name, c in costs.items():
        log(f"[step-bytes] {name}: host us a call (median of {HOST_CALLS}) registered op "
            f"{c['op_host_us']:.2f}, ctypes wrapper {c['wrapper_host_us']:.2f} (+"
            f"{c['op_host_us'] - c['wrapper_host_us']:.2f}); device ms a call in a CUDA graph "
            f"op {c['op_graph_ms']:.4f}, wrapper {c['wrapper_graph_ms']:.4f}")
    log(f"[step-bytes] the fopo-paper step with the registered ops (phase 5): p50 "
        f"{tres['p50_ms']:.3f} ms, p99 {tres['p99_ms']:.3f} ms, device idle "
        f"{100 * tres['idle']:.1f} %; phase {time.perf_counter() - t_phase:.1f} s")
    res["op_costs"] = costs
    res["launches"] = {name: sum(res[key]["kernel_ops"].get(name, 0)
                                 for key in ("pallas", "ivf_pallas"))
                       for name in op_kernels()}
    res["launches"]["embedding_bag"] = 1
    return res


def percentile(values: list[float], p: float) -> float:
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, round(p / 100.0 * (len(vs) - 1))))]


def new_phases(ds, theta0, cfg, params, payloads) -> tuple:
    """The phases of the maintained index, the guard, the checkpoint,
    telemetry, the serving ladder and the cluster (5b-5e, 4b, 4c)."""
    import torch

    log("[maintain] fopo-paper on the maintained index (retriever=ivf_pallas, "
        "RefreshConfig() defaults, fused, fused_sampler, TS 8)")
    mres = maintained_train_phase(ds, theta0)
    gres = guard_phase(ds, theta0, mres["index0"], mres["seeds"])
    cres = checkpoint_phase(mres["tr"], ds, theta0, mres["index0"])
    del mres["tr"], mres["index0"]
    torch.cuda.empty_cache()
    ores = obs_phase(ds, theta0)
    torch.cuda.empty_cache()
    lad = serve_ladder_phase(cfg, params)
    torch.cuda.empty_cache()
    clu = cluster_phase(cfg, params, payloads)
    torch.cuda.empty_cache()
    return mres, gres, cres, ores, lad, clu


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
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.flash_attention import kernel as flk
    from repro_torch.kernels.fused_sampler import kernel as fk
    from repro_torch.kernels.mips_topk import kernel as mk
    from repro_torch.kernels.snis_covgrad import kernel as sk

    sources = [kernel.SOURCE, mk.SOURCE, fk.SOURCE, sk.FWD_SOURCE, sk.BWD_SOURCE, flk.SOURCE,
               flk.BWD_SOURCE, ek.SOURCE]
    t0 = time.perf_counter()
    _build.build(sources)
    for lib in (kernel.library, mk.library, fk.library, sk.fwd_library, sk.bwd_library,
                flk.library, flk.bwd_library, ek.library):
        lib()
    log(f"[build] {', '.join(str(x.relative_to(ROOT)) for x in sources)} built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    sass = {}
    for src in (flk.SOURCE, flk.BWD_SOURCE):
        sass[src.name] = n = hmma_count(src)
        check(n > 0, f"{src.name}: no HMMA instruction in its SASS")
        log(f"[build] {src.name}: {n} HMMA (tensor-core) instructions in its SASS "
            f"(cuobjdump -sass)")

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

    # 5b-5d. the maintained index, the guard and its faults, a checkpoint;
    # 4b. the serving ladder at full SASRec width
    # 5e. telemetry; 4c. the cluster at full SASRec width
    mres, gres, cres, ores, lad, clu = new_phases(ds, theta0, cfg, params, payloads)

    # 5f. multiple devices: NCCL with one rank, gloo with four on the card
    log("[dist] fopo-paper on the (data, model) grid of repro_torch.dist (fused, "
        "fused_sampler, TS 8): drill A on NCCL, drill B on gloo")
    dres = dist_phase(ds, theta0)

    # 13. one fopo-paper step under the op walker on the card and on meta
    # tensors, on both routes; K8 at the DLRM shape; K1-K8's host costs
    log("[step-bytes] jaxpr_step_bytes over one fopo-paper step at full width, the K1-K8 "
        "registered operators held to their launches, their rules and their data")
    sres = step_bytes_phase(ds, theta0, tres)
    del ds, theta0, route, planner, state, index, users, engine
    torch.cuda.empty_cache()

    # 6. embedding_bag (K8) against its plain version, and its path at the
    # DLRM shape; the tables are freed before the LM phases
    log("[kernels] embedding_bag (K8) vs its plain version, on the card (bit for bit: both "
        "add the live rows in t order in the table's dtype)")
    with torch.inference_mode():
        eres = embedding_bag_phase()
    torch.cuda.empty_cache()

    # 7. DIN, DIEN and Wide&Deep serving at full width
    rres = {}
    for arch in ("din", "dien", "wide-deep"):
        rres[arch] = recsys_phase(arch)
        torch.cuda.empty_cache()

    # 7b. recsys training at full width, replayed on the CPU
    rtrain = recsys_train_phase()

    # 7c. GraphCast training at full width, replayed on the CPU
    gtrain = gnn_train_phase()

    # 8. flash attention (K9) against its plain version
    log("[kernels] flash_attention (K9) vs its plain version, on the card (fp32 out: rtol "
        f"{RTOL}, atol {ATOL} scaled by max |out| (sums of terms of both signs); bf16 out: rtol "
        f"2^-7 (one bf16 ulp), atol {ATOL}; lse: rtol {RTOL}, atol 1e-5)")
    with torch.inference_mode():
        fres = flash_phase()

    # 9. the flash-attention backward (K10) against its plain version
    log("[kernels] flash_attention_bwd (K10) vs its plain version, on the card, dq, dk, dv "
        f"(fp32: rtol {RTOL}, atol {ATOL} scaled by max |grad| (sums of terms of both signs); "
        f"bf16: rtol 2^-7 (one bf16 ulp), atol {ATOL} + {RTOL} max |grad|; the plain version "
        "sums the GQA group in fp32 and rounds once, as the kernel)")
    bres = flash_bwd_phase()

    # 10. the Gemma-2 2B generation path at full width, and its gate
    lres = lm_phase()

    # 11. the Gemma-2 2B training path at full width, and its gate
    tlm = lm_train_phase()

    # 11b. OLMoE-1B-7B: generation at full width, training at 4 layers, the FOPO LM head
    olm = olmoe_phase()

    # 12. the dry run: four cells on the card's 1 x 1 mesh held to their dry
    # run, three production cells dry-run on the pod mesh
    dry = dryrun_phase()
    dry_k = [c["launches"] for c in dry["cells"].values()]

    # 14. the kernels line, the card, the result
    t = kres["timing"]["main K=10"]
    entries = [{
        "name": "ivf_topk",
        "route": "cuda",
        "source": str(kernel.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ivf_topk/kernel.py:86",
        "launches": (launches + lres["counts"]["ivf_probe_topk_cuda.launches"]
                     + olm["gen"]["counts"]["ivf_probe_topk_cuda.launches"]
                     + sum(r["ivf_launches"] for r in rres.values())
                     + mres["counts"]["ivf_probe_topk_cuda.launches"]
                     + clu["launches"] + dres["counts"]["ivf_probe_topk_cuda.launches"]
                     + sres["launches"]["ivf_probe_topk"]),
        "max_abs_err": max(kres["max_abs_err"], lres["ivf_lm"]["max_abs_err"],
                           olm["gen"]["ivf_lm"]["max_abs_err"], mres["k7_err"],
                           clu["max_abs_err"]),
        "ms": t["ms"],
        "kernel_ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        **sres["op_costs"]["ivf_probe_topk"],
        "shape": "SASRec serving: B 8, L 50, C 1024, n_probe 8, K 10 (main lists)",
        **{key: {x: tt[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")} for key, tt in (
            ("k256", kres["timing"]["main K=256"]),
            ("full_lists_l2304", kres["timing"]["full lists L=2304"]),
            ("lm_shape", lres["ivf_lm"]),
            ("olmoe_lm_shape_l2048", olm["gen"]["ivf_lm"]),
            ("dien_l18", rres["dien"]["ivf_l18"]),
            ("training_k256_main", mres["gates"]["k7_main_k256"]),
            ("training_k256_live_delta", mres["gates"]["k7_delta_live"]),
        )},
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
            "launches": (tres["counts"][f"{launch_fn.__name__}.launches"]
                         + mres["counts"][f"{launch_fn.__name__}.launches"]
                         + ores["counts"][f"{launch_fn.__name__}.launches"]
                         + dres["counts"][f"{launch_fn.__name__}.launches"]
                         + sres["launches"][name]),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **sres["op_costs"][name],
        })
        if name == "mips_topk":
            entries[-1].update(floor_ms=r["floor_ms"], probe_ms=r["probe_ms"],
                               merge_ms=r["merge_ms"])
        if name == "fused_sampler":
            entries[-1].update({key: r[key] for key in (
                "ms_eps1", "ms_eps0", "instructions_per_slot", "instructions_per_kappa_draw",
                "instructions_per_uniform_draw")})
        if name == "snis_covgrad_bwd":
            entries[-1].update(ms_all_dead=r["ms_all_dead"], ms_l2_hot=r["ms_l2_hot"])
        if name == "snis_covgrad_fwd":  # ms: scores mode over the 4 input sets
            extra = ("ms_l2_hot", "ms_past_l2", "ms_all_dead", "bound_ms_past_l2",
                     "bound_ms_all_dead")
            entries[-1].update({key: r[key] for key in extra})
            cm = tk["snis_covgrad_fwd_covgrad_mode"]
            entries[-1]["covgrad_mode"] = {key: cm[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", *extra)}
        if name.startswith("snis_covgrad"):  # the wide path, B 32, S 1000
            modes = ("fwd", "covgrad") if name.endswith("fwd") else ("bwd",)
            entries[-1]["wide_l"] = {
                f"L {ll} {mode}": {k: tk["snis_covgrad_wide"][ll][mode][k]
                                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                for ll in tk["snis_covgrad_wide"] for mode in modes}
    ft = fres["timing"]
    t = ft["gemma prefill"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    entries.append({
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": str(flk.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/kernel.py:104",
        "launches": (lres["counts"]["flash_attention_fwd_cuda.launches"]
                     + tlm["counts"]["flash_attention_fwd_cuda.launches"]
                     + olm["gen"]["counts"]["flash_attention_fwd_cuda.launches"]
                     + olm["train"]["counts"]["flash_attention_fwd_cuda.launches"]
                     + sum(c["flash_attention_fwd_cuda.launches"] for c in dry_k)),
        "max_abs_err": fres["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": "B 8, S 2048, H 8, KV 4, D 256, causal, cap 50, bf16 (the Gemma-2 prefill)",
        "training_b1_fp32": {k: ft["training B 1 fp32"][k] for k in keys},
        "training_b1_bf16": {k: ft["training B 1 bf16"][k] for k in keys},
        "olmoe_prefill": {k: ft["olmoe prefill"][k] for k in (*keys, "library_ms")},
        "olmoe_training_b1_fp32": {k: ft["olmoe training B 1 fp32"][k] for k in keys},
        "hmma_in_sass": sass[flk.SOURCE.name],
    })
    # K10's headline is the main path's shape: one 2048-token row per
    # microbatch, fp32 parameters in 5 of the 6 steps
    bt = bres["timing"]
    t, t4 = bt["main path B 1 fp32"], bt["training B 4 bf16"]
    entries.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": str(flk.BWD_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/backward.py:136",
        "launches": (tlm["counts"]["flash_attention_bwd_cuda.launches"]
                     + olm["train"]["counts"]["flash_attention_bwd_cuda.launches"]
                     + sum(c["flash_attention_bwd_cuda.launches"] for c in dry_k)),
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
        "olmoe_main_path_b1_fp32": {k: bt["olmoe main path B 1 fp32"][k] for k in keys},
        "olmoe_main_path_b1_bf16": {k: bt["olmoe main path B 1 bf16"][k] for k in keys},
        "b4_bf16_fwd_bwd": {
            "flex_attention_ms": t4["library"]["ms"],
            "port_k9_k10_ms": t4["library"]["port_ms"],
            "note": "forward + backward at B 4 bf16, each eager and timed with CUDA events",
        },
        "hmma_in_sass": sass[flk.BWD_SOURCE.name],
    })
    # K8's headline is the ragged fp32 DLRM bags; the other shapes beside it
    et = eres["timing"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries.append({
        "name": "embedding_bag",
        "route": "cuda",
        "source": str(ek.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:49",
        "launches": eres["launches"] + sres["launches"]["embedding_bag"],
        "max_abs_err": eres["max_abs_err"],
        **{k: et["ragged fp32"][k] for k in keys},
        **sres["op_costs"]["embedding_bag"],
        "shape": "table 40,000,000 x 128 fp32, B 4096, T 100, lengths uniform in 1-100 "
                 "(-1 padded), ids uniform; library: F.embedding_bag over the live ids with "
                 "offsets",
        "full_fp32": {k: et["full fp32"][k] for k in keys},
        "ragged_bf16": {k: et["ragged bf16"][k] for k in keys},
        "full_bf16": {k: et["full bf16"][k] for k in keys},
    })
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--dist-rank":  # a rank of phase 5f's drill B
        sys.exit(dist_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
