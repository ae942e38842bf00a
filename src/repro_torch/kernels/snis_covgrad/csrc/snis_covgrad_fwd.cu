// Fused beta-gather + SNIS + covariance gradient, the forward of the FOPO
// training step, for Hopper (sm_90a), written by hand in CUDA C++ with a
// plain C interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/snis_covgrad/kernel.py:snis_covgrad_fwd_pallas
// (per-sample tiling) and :snis_covgrad_fwd_tiled_pallas (TS-row tiles).
// On the card the TS tiling is only the wrapper's padding of S: this
// kernel reads its own actions, so one function serves both.
//
// Computes, for each batch row b and sample s:
//   f_bs = h_b . beta[max(a_bs, 0)]     (a masked slot scores row 0)
// and, in covgrad mode, the online softmax of f - log q with the weight
// exactly 0 (a select, not an underflow) where log q >= 1.5e38:
//   m = max, z = sum w, R = sum w r, A = sum w r beta_a, C = sum w beta_a
//   g_b = (A - (R / z') C) / z',  z' = max(z, 1e-30)
// so a row whose slots are all masked gives g = 0 exactly.
//
// Bound. Scores only (the training forward): the gathered rows, each
// distinct row once (at most B * S * L * 4 bytes: 12.8 MB at B 32, S
// 1000, L 100, 3.8 us at 3.35 TB/s), plus the actions read and the scores
// written; 2 L flops per row, far below the card's balance point. Bound
// by bytes; but the rows are scattered 400-byte reads, each behind the
// read of its action, so what sets the time is how many of them are in
// flight and how many round trips lie in series before the last score.
//
// What the design does about that bound:
//   * The [B, S, L] gathered tensor never exists: each row is read once,
//     as 16-byte words, straight into registers and scored there.
//   * Scores mode, three round trips a warp: its samples' actions (with
//     h) in one read, a lane each, passed round by shuffles; then every
//     row word of its samples, issued before the first FMA (each group of
//     lanes holds two samples' rows); then the scores written. No barrier:
//     each warp goes on as soon as its own actions are in.
//   * A row of L = 100 floats is 25 words. `lanes` lanes share a sample,
//     each holding NV = ceil(L / 4 / lanes) words: the wrapper picks the
//     lanes that leave the fewest of a warp's 32 x NV load slots idle
//     (`kernel.fwd_lanes`: 5 lanes x 5 words at L 100, six samples a warp,
//     150 of its 160 load slots busy; 8 lanes x 4 words would fill 100 of
//     128). A group's partial dot products are added in a fixed order by a
//     shuffle tree into its first lane.
//   * S is split across blocks, grid (splits, B), each chunk one pass of
//     the block where S allows (`kernel.splits_for`: 11 chunks of 96 at
//     B 32, S 1000, 352 blocks, all resident at once).
//   * Covgrad mode keeps its own kernel, `snis_fwd_covgrad`: 8 lanes a
//     sample, a group reading a sample's action, log q and reward, then
//     its row, one sample at a time, and folding it into an online softmax
//     held in registers (m, z, R and its slices of A and C). The front end
//     above, at 5 or 8 lanes a sample and one or two samples a group, made
//     this mode slower on the card (PERF.md, the K1/K2 redesign). The
//     block combines its groups through shared memory and writes one
//     partial per (row, split); `snis_fwd_finalize` folds the splits'
//     partials (they combine associatively after rescaling to a common
//     max) and finalises g.
//   * Those register layouts (at most 8 words a lane) take L a multiple
//     of 4 up to 256, fopo-paper's L 100 among them. Any other L takes
//     the wide path, `snis_fwd_wide`: one warp per sample, a row read in
//     32-word chunks (16-byte words where L is a multiple of 4, 4-byte
//     words otherwise, since such a row is not 16-byte aligned), so the
//     dot product loops over chunks with its partial sum in a register
//     and the online softmax still folds one row at a time. The warp's
//     A and C live in shared memory ([warps][L] each, every lane touching
//     only its own words), the row is read again for the fold (an L1
//     hit), and the block combines its warps as above. Shared memory
//     bounds L there: 8 warps up to L 3,600, one warp up to about 29,000
//     (covgrad mode; the scores-only mode takes any L).

#include <cuda_runtime.h>
#include <stdint.h>

#include "snis_covgrad_wide.cuh"

using snis_wide::Word;
using snis_wide::warp_sum;
using snis_wide::wide_warps;
using snis_wide::zero_word;

#define NEG_INF_F (-3.0e38f)
#define LOG_Q_VALID_MAX_F (1.5e38f)

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                    // covgrad mode: lanes per sample
constexpr int kGroups = kThreads / kGroup;   // covgrad mode: samples in flight per block
constexpr int kBatch = 2;     // scores mode: samples a group's lanes hold at once
constexpr int kMaxWords = 8;  // scores mode: 16-byte words of a row a lane holds (NV)

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpby(float4 x, float a, float4 y, float c) {
  // a * x + c * y, elementwise
  return make_float4(fmaf(a, x.x, c * y.x), fmaf(a, x.y, c * y.y),
                     fmaf(a, x.z, c * y.z), fmaf(a, x.w, c * y.w));
}

// Scores mode. grid (splits, B). NV = 16-byte words per lane, g =
// `lanes` lanes per sample (L / 4 <= g * NV), 32 / g samples per warp,
// kBatch samples per group in a pass of groups * kBatch samples. Block
// (j, b) scores samples [j * chunk, min(S, (j + 1) * chunk)) of row b,
// pass by pass; the pass's sample q * groups + grp is group grp's q-th.
template <int NV>
__global__ void __launch_bounds__(kThreads, NV <= 5 ? 3 : 2) snis_fwd_scores(
    const float* __restrict__ h, const float* __restrict__ beta,
    const int* __restrict__ actions, float* __restrict__ scores, int S, int L, int chunk,
    int lanes) {
  const int b = blockIdx.y, split = blockIdx.x;
  const int lo = split * chunk, n = min(S, lo + chunk) - lo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lanes, spw = 32 / g;
  const int gw = lane / g, gl = lane - gw * g;
  const bool in_group = gw < spw;  // the lanes past spw * g idle
  const int groups = (kThreads / 32) * spw;
  const int pass = groups * kBatch;
  const int L4 = L >> 2;
  const float4* beta4 = reinterpret_cast<const float4*>(beta);
  // the warp's samples of a pass: lane k < spw * kBatch reads the action of
  // its group k % spw's (k / spw)-th
  const int mine = (lane / spw) * groups + warp * spw + lane % spw;
  const bool reads = lane < spw * kBatch;

  float4 hv[NV];
  {
    const float4* h4 = reinterpret_cast<const float4*>(h) + (size_t)b * L4;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int f = gl + g * v;
      hv[v] = in_group && f < L4 ? __ldg(h4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int p0 = 0; p0 < n; p0 += pass) {  // the same passes for every warp
    const int np = min(pass, n - p0);
    const size_t at0 = (size_t)b * S + lo + p0;
    // the warp's actions in one round trip (beside h's, the first pass)
    const int a_mine = reads && mine < np ? __ldg(actions + at0 + mine) : -1;
    // every row word of the warp's samples issued before the first FMA
    float4 bv[kBatch][NV];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int a = __shfl_sync(0xffffffffu, a_mine, q * spw + (in_group ? gw : 0));
      const bool active = in_group && q * groups + warp * spw + gw < np;
      const float4* row = beta4 + (size_t)max(a, 0) * L4;  // a masked slot scores row 0
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int f = gl + g * v;
        bv[q][v] = active && f < L4 ? __ldg(row + f) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = q * groups + warp * spw + gw;
      float d = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) d = dot4(hv[v], bv[q][v], d);
      // the group's sum in a fixed order into its first lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, d, o);
        if (o < g && gl + o < g) d += y;
      }
      if (in_group && gl == 0 && i < np) scores[at0 + i] = d;
    }
  }
}

// Covgrad mode. grid (splits, B). NV = 16-byte words per lane (L / 4 <=
// 8 * NV). Block (j, b) handles samples [j * chunk, min(S, (j + 1) *
// chunk)) of row b and writes its partial (m, z, R, A[L], C[L]) to
// part[(b * splits + j) * (3 + 2L)].
template <int NV>
__global__ void __launch_bounds__(kThreads) snis_fwd_covgrad(
    const float* __restrict__ h, const float* __restrict__ beta,
    const int* __restrict__ actions, const float* __restrict__ log_q,
    const float* __restrict__ rewards, float* __restrict__ scores,
    float* __restrict__ part, int S, int L, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, split = blockIdx.x;
  const int lo = split * chunk, hi = min(S, lo + chunk);
  const int tid = threadIdx.x, grp = tid / kGroup, gl = tid % kGroup;
  const int L4 = L >> 2;
  const float4* h4 = reinterpret_cast<const float4*>(h) + (size_t)b * L4;
  const float4* beta4 = reinterpret_cast<const float4*>(beta);

  float4 hv[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int f = gl + kGroup * v;
    hv[v] = f < L4 ? h4[f] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF_F, z = 0.f, rs = 0.f;
  float4 A[NV], C[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    A[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    C[v] = A[v];
  }

  // a warp-uniform trip count: the group shuffles need every lane
  for (int base = lo; base < hi; base += kGroups) {
    const int s = base + grp;
    const bool active = s < hi;
    const size_t at = (size_t)b * S + s;
    const int a = active ? actions[at] : 0;
    const float4* row = beta4 + (size_t)max(a, 0) * L4;
    float4 bv[NV];
    float part_dot = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int f = gl + kGroup * v;
      bv[v] = (active && f < L4) ? __ldg(row + f) : make_float4(0.f, 0.f, 0.f, 0.f);
      part_dot = dot4(hv[v], bv[v], part_dot);
    }
    const float score = group_sum(part_dot);
    if (!active) continue;
    if (gl == 0) scores[at] = score;
    const float lq = log_q[at];
    const float r = rewards[at];
    const bool valid = lq < LOG_Q_VALID_MAX_F;
    const float logw = valid ? score - lq : NEG_INF_F;
    const float m_new = fmaxf(m, logw);
    const float alpha = expf(m - m_new);
    const float w = valid ? expf(logw - m_new) : 0.f;
    const float wr = w * r;
    z = z * alpha + w;
    rs = rs * alpha + wr;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      A[v] = axpby(bv[v], wr, A[v], alpha);
      C[v] = axpby(bv[v], w, C[v], alpha);
    }
    m = m_new;
  }

  // combine the block's groups at a common max, in group order
  float* gm = smem;                       // [kGroups]
  float* gz = gm + kGroups;               // [kGroups]
  float* gr = gz + kGroups;               // [kGroups]
  float* gA = gr + kGroups;               // [kGroups][L]
  float* gC = gA + kGroups * L;           // [kGroups][L]
  if (gl == 0) gm[grp] = m;
  __syncthreads();
  float M = gm[0];
  for (int g = 1; g < kGroups; ++g) M = fmaxf(M, gm[g]);
  const float scale = expf(m - M);
  if (gl == 0) {
    gz[grp] = z * scale;
    gr[grp] = rs * scale;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int f = gl + kGroup * v;
    if (f < L4) {
      reinterpret_cast<float4*>(gA + grp * L)[f] =
          make_float4(A[v].x * scale, A[v].y * scale, A[v].z * scale, A[v].w * scale);
      reinterpret_cast<float4*>(gC + grp * L)[f] =
          make_float4(C[v].x * scale, C[v].y * scale, C[v].z * scale, C[v].w * scale);
    }
  }
  __syncthreads();
  float* out = part + ((size_t)b * gridDim.x + split) * (3 + 2 * L);
  if (tid == 0) {
    float zs = 0.f, rsum = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      zs += gz[g];
      rsum += gr[g];
    }
    out[0] = M;
    out[1] = zs;
    out[2] = rsum;
  }
  for (int l = tid; l < L; l += kThreads) {
    float sa = 0.f, sc = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      sa += gA[g * L + l];
      sc += gC[g * L + l];
    }
    out[3 + l] = sa;
    out[3 + L + l] = sc;
  }
}

// grid (B). Folds row b's `splits` partials in split order and writes
// g_b = (A - (R / z') C) / z', z' = max(z, 1e-30).
__global__ void __launch_bounds__(kThreads) snis_fwd_finalize(
    const float* __restrict__ part, float* __restrict__ grad, int splits, int L) {
  const int b = blockIdx.x;
  const int width = 3 + 2 * L;
  const float* p = part + (size_t)b * splits * width;
  float M = p[0];
  for (int j = 1; j < splits; ++j) M = fmaxf(M, p[(size_t)j * width]);
  float z = 0.f, rs = 0.f;
  for (int j = 0; j < splits; ++j) {
    const float sc = expf(p[(size_t)j * width] - M);
    z += p[(size_t)j * width + 1] * sc;
    rs += p[(size_t)j * width + 2] * sc;
  }
  const float zf = fmaxf(z, 1e-30f);
  const float rbar = rs / zf;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    float a = 0.f, c = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float* q = p + (size_t)j * width;
      const float sc = expf(q[0] - M);
      a += q[3 + l] * sc;
      c += q[3 + L + l] * sc;
    }
    grad[(size_t)b * L + l] = (a - rbar * c) / zf;
  }
}

__device__ __forceinline__ float dotw(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ float dotw(float4 a, float4 b, float acc) { return dot4(a, b, acc); }
__device__ __forceinline__ float axpby(float x, float a, float y, float c) {
  return fmaf(a, x, c * y);
}

// grid (splits, B), block 32 * warps. Any L: warp w of block (j, b)
// scores samples lo + w, lo + w + warps, ... of row b; lane owns the
// words lane + 32 k. In covgrad mode the warp folds its samples into
// (m, z, R) in registers and A, C in shared memory, and the block writes
// the same partial as `snis_fwd_covgrad`.
template <int VEC, bool COVGRAD>
__global__ void __launch_bounds__(kThreads) snis_fwd_wide(
    const float* __restrict__ h, const float* __restrict__ beta,
    const int* __restrict__ actions, const float* __restrict__ log_q,
    const float* __restrict__ rewards, float* __restrict__ scores,
    float* __restrict__ part, int S, int L, int chunk) {
  using W = typename Word<VEC>::T;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y, split = blockIdx.x;
  const int lo = split * chunk, hi = min(S, lo + chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LW = L / VEC;
  const W* hw = reinterpret_cast<const W*>(h + (size_t)b * L);
  const W* bw = reinterpret_cast<const W*>(beta);
  W* A = reinterpret_cast<W*>(smem + (size_t)warp * 2 * L);  // [warps][2][L]
  W* C = reinterpret_cast<W*>(smem + (size_t)warp * 2 * L + L);
  float* gm = smem + (size_t)warps * 2 * L;                   // [warps]
  float* gz = gm + warps;                                     // [warps]
  float* gr = gz + warps;                                     // [warps]
  if (COVGRAD) {
    for (int f = lane; f < LW; f += 32) {
      A[f] = zero_word<W>();
      C[f] = zero_word<W>();
    }
  }
  float m = NEG_INF_F, z = 0.f, rs = 0.f;
  for (int s = lo + warp; s < hi; s += warps) {
    const size_t at = (size_t)b * S + s;
    const int a = actions[at];
    const W* row = bw + (size_t)max(a, 0) * LW;
    float d = 0.f;
    for (int f = lane; f < LW; f += 32) d = dotw(__ldg(hw + f), __ldg(row + f), d);
    const float score = warp_sum(d);
    if (lane == 0) scores[at] = score;
    if (COVGRAD) {
      const float lq = log_q[at];
      const float r = rewards[at];
      const bool valid = lq < LOG_Q_VALID_MAX_F;
      const float logw = valid ? score - lq : NEG_INF_F;
      const float m_new = fmaxf(m, logw);
      const float alpha = expf(m - m_new);
      const float w = valid ? expf(logw - m_new) : 0.f;
      const float wr = w * r;
      z = z * alpha + w;
      rs = rs * alpha + wr;
      for (int f = lane; f < LW; f += 32) {
        const W x = __ldg(row + f);
        A[f] = axpby(x, wr, A[f], alpha);
        C[f] = axpby(x, w, C[f], alpha);
      }
      m = m_new;
    }
  }
  if (!COVGRAD) return;

  // combine the block's warps at a common max, in warp order
  if (lane == 0) gm[warp] = m;
  __syncthreads();
  float M = gm[0];
  for (int g = 1; g < warps; ++g) M = fmaxf(M, gm[g]);
  __syncthreads();  // every thread has read gm before it is overwritten
  if (lane == 0) {
    const float scale = expf(m - M);
    gm[warp] = scale;
    gz[warp] = z * scale;
    gr[warp] = rs * scale;
  }
  __syncthreads();
  float* out = part + ((size_t)b * gridDim.x + split) * (3 + 2 * L);
  if (tid == 0) {
    float zs = 0.f, rsum = 0.f;
    for (int g = 0; g < warps; ++g) {
      zs += gz[g];
      rsum += gr[g];
    }
    out[0] = M;
    out[1] = zs;
    out[2] = rsum;
  }
  for (int l = tid; l < L; l += blockDim.x) {
    float sa = 0.f, sc = 0.f;
    for (int g = 0; g < warps; ++g) {
      sa += smem[(size_t)g * 2 * L + l] * gm[g];
      sc += smem[(size_t)g * 2 * L + L + l] * gm[g];
    }
    out[3 + l] = sa;
    out[3 + L + l] = sc;
  }
}

template <int NV>
cudaError_t launch_scores(const float* h, const float* beta, const int* actions, float* scores,
                          int B, int S, int L, int splits, int chunk, int lanes,
                          cudaStream_t st) {
  snis_fwd_scores<NV><<<dim3(splits, B), kThreads, 0, st>>>(h, beta, actions, scores, S, L,
                                                             chunk, lanes);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_covgrad(const float* h, const float* beta, const int* actions,
                           const float* log_q, const float* rewards, float* scores,
                           float* part, float* grad, int B, int S, int L, int splits,
                           int chunk, cudaStream_t st) {
  const size_t smem = (size_t)(3 * kGroups + 2 * kGroups * L) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)snis_fwd_covgrad<NV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  snis_fwd_covgrad<NV><<<dim3(splits, B), kThreads, smem, st>>>(
      h, beta, actions, log_q, rewards, scores, part, S, L, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  snis_fwd_finalize<<<B, kThreads, 0, st>>>(part, grad, splits, L);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_wide(const float* h, const float* beta, const int* actions,
                        const float* log_q, const float* rewards, float* scores,
                        float* part, float* grad, int B, int S, int L, int splits,
                        int chunk, bool covgrad, cudaStream_t st) {
  dim3 grid(splits, B);
  if (!covgrad) {
    snis_fwd_wide<VEC, false><<<grid, kThreads, 0, st>>>(
        h, beta, actions, log_q, rewards, scores, part, S, L, chunk);
    return cudaGetLastError();
  }
  size_t smem = 0;
  const int warps = wide_warps(2 * (size_t)L + 3, kThreads / 32, &smem);
  if (warps < 1) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)snis_fwd_wide<VEC, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  snis_fwd_wide<VEC, true><<<grid, 32 * warps, smem, st>>>(
      h, beta, actions, log_q, rewards, scores, part, S, L, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  snis_fwd_finalize<<<B, kThreads, 0, st>>>(part, grad, splits, L);
  return cudaGetLastError();
}

// The forward at any L: in scores mode the register layout at `lanes`
// lanes a sample (L a multiple of 4, L / 4 <= lanes * kMaxWords), in
// covgrad mode the register layout at 8 lanes a sample (L a multiple of 4
// up to 256); the wide path where `lanes` is 0, L is not a multiple of 4,
// or `wide_only`.
int launch(const void* h, const void* beta, const void* actions, const void* log_q,
           const void* rewards, void* scores, void* part, void* grad, int B, int S,
           int L, int splits, int chunk, int lanes, int covgrad, void* stream,
           bool wide_only) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes < 0 || lanes > 32) return (int)cudaErrorInvalidValue;
  const auto* hp = static_cast<const float*>(h);
  const auto* bp = static_cast<const float*>(beta);
  const auto* ap = static_cast<const int*>(actions);
  auto* sp = static_cast<float*>(scores);
  cudaError_t err;
  if (wide_only || lanes == 0 || L % 4 != 0) {
#define WIDE_ARGS hp, bp, ap, static_cast<const float*>(log_q), \
      static_cast<const float*>(rewards), sp, static_cast<float*>(part), \
      static_cast<float*>(grad), B, S, L, splits, chunk, covgrad != 0, st
    err = L % 4 ? launch_wide<1>(WIDE_ARGS) : launch_wide<4>(WIDE_ARGS);
#undef WIDE_ARGS
  } else if (covgrad) {
    const int nv = (L / 4 + kGroup - 1) / kGroup;
#define COV_ARGS hp, bp, ap, static_cast<const float*>(log_q), \
      static_cast<const float*>(rewards), sp, static_cast<float*>(part), \
      static_cast<float*>(grad), B, S, L, splits, chunk, st
    if (nv > kMaxWords) return (int)cudaErrorInvalidValue;
    else if (nv <= 1) err = launch_covgrad<1>(COV_ARGS);
    else if (nv <= 2) err = launch_covgrad<2>(COV_ARGS);
    else if (nv <= 4) err = launch_covgrad<4>(COV_ARGS);
    else err = launch_covgrad<8>(COV_ARGS);
#undef COV_ARGS
  } else {
#define SC_ARGS hp, bp, ap, sp, B, S, L, splits, chunk, lanes, st
    switch ((L / 4 + lanes - 1) / lanes) {
      case 1: err = launch_scores<1>(SC_ARGS); break;
      case 2: err = launch_scores<2>(SC_ARGS); break;
      case 3: err = launch_scores<3>(SC_ARGS); break;
      case 4: err = launch_scores<4>(SC_ARGS); break;
      case 5: err = launch_scores<5>(SC_ARGS); break;
      case 6: err = launch_scores<6>(SC_ARGS); break;
      case 7: err = launch_scores<7>(SC_ARGS); break;
      case 8: err = launch_scores<8>(SC_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef SC_ARGS
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Launches the forward on `stream`, any L >= 1: the register layout at
// `lanes` lanes a sample (`kernel.fwd_lanes`), or the wide path where
// `lanes` is 0; returns cudaGetLastError(), or cudaErrorInvalidValue where
// `lanes` cannot hold L or covgrad mode's A and C for one warp exceed the
// block's shared memory. In covgrad mode `part` is scratch of
// B * splits * (3 + 2L) floats and `grad` the [B, L] output; otherwise
// both are unused.
int snis_fwd_launch(const void* h, const void* beta, const void* actions,
                    const void* log_q, const void* rewards, void* scores, void* part,
                    void* grad, int B, int S, int L, int splits, int chunk, int lanes,
                    int covgrad, void* stream) {
  return launch(h, beta, actions, log_q, rewards, scores, part, grad, B, S, L, splits,
                chunk, lanes, covgrad, stream, false);
}

// The same through the wide path at every L: `chip_smoke.py` times it
// against the register layout at fopo-paper's L 100.
int snis_fwd_launch_wide(const void* h, const void* beta, const void* actions,
                         const void* log_q, const void* rewards, void* scores,
                         void* part, void* grad, int B, int S, int L, int splits,
                         int chunk, int lanes, int covgrad, void* stream) {
  return launch(h, beta, actions, log_q, rewards, scores, part, grad, B, S, L, splits,
                chunk, lanes, covgrad, stream, true);
}

const char* snis_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
