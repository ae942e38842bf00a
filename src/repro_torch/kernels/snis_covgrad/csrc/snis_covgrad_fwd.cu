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
// Bound. Scores only (the training forward): the gathered rows,
// B * S * L * 4 bytes (12.8 MB at B 32, S 1000, L 100: 3.8 us at
// 3.35 TB/s), plus the actions read and the scores written; 2 L flops per
// row, far below the card's balance point. Bound by bytes; but the rows
// are scattered 400-byte reads, so the memory system must be kept busy
// with many independent reads in flight.
//
// What the design does about that bound:
//   * The [B, S, L] gathered tensor never exists: each row is read once,
//     as 16-byte words, straight into registers and scored there.
//   * Eight lanes share one sample (a row of L = 100 floats is 25 words),
//     so a warp reads four rows at once and a block of 256 threads 32.
//   * S is split across blocks, grid (splits, B), so at B = 32 the card
//     has several hundred blocks in flight, not 32 (one per row would
//     leave 100 of 132 SMs idle).
//   * In covgrad mode each 8-lane group folds its samples into an online
//     softmax held in registers (m, z, R and its slices of A and C); the
//     block combines its 32 groups through shared memory and writes one
//     partial per (row, split); `snis_fwd_finalize` folds the splits'
//     partials (they combine associatively after rescaling to a common
//     max) and finalises g.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-3.0e38f)
#define LOG_Q_VALID_MAX_F (1.5e38f)

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                    // lanes per sample
constexpr int kGroups = kThreads / kGroup;   // samples in flight per block

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

// grid (splits, B). NV = 16-byte words per lane (L / 4 <= 8 * NV).
// Block (j, b) handles samples [j * chunk, min(S, (j + 1) * chunk)) of
// row b; in covgrad mode it writes its partial (m, z, R, A[L], C[L]) to
// part[(b * splits + j) * (3 + 2L)].
template <int NV, bool COVGRAD>
__global__ void __launch_bounds__(kThreads) snis_fwd_kernel(
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
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        A[v] = axpby(bv[v], wr, A[v], alpha);
        C[v] = axpby(bv[v], w, C[v], alpha);
      }
      m = m_new;
    }
  }
  if (!COVGRAD) return;

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

template <int NV>
cudaError_t launch_nv(const float* h, const float* beta, const int* actions,
                      const float* log_q, const float* rewards, float* scores,
                      float* part, float* grad, int B, int S, int L, int splits,
                      int chunk, bool covgrad, cudaStream_t st) {
  dim3 grid(splits, B);
  if (!covgrad) {
    snis_fwd_kernel<NV, false><<<grid, kThreads, 0, st>>>(
        h, beta, actions, log_q, rewards, scores, part, S, L, chunk);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)(3 * kGroups + 2 * kGroups * L) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)snis_fwd_kernel<NV, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  snis_fwd_kernel<NV, true><<<grid, kThreads, smem, st>>>(
      h, beta, actions, log_q, rewards, scores, part, S, L, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  snis_fwd_finalize<<<B, kThreads, 0, st>>>(part, grad, splits, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest L the kernel takes (a multiple of 4): 8 lanes x 8 words x 4.
int snis_fwd_max_dim(void) { return kGroup * 8 * 4; }

// Launches the forward on `stream`; returns cudaGetLastError(). In
// covgrad mode `part` is scratch of B * splits * (3 + 2L) floats and
// `grad` the [B, L] output; otherwise both are unused.
int snis_fwd_launch(const void* h, const void* beta, const void* actions,
                    const void* log_q, const void* rewards, void* scores, void* part,
                    void* grad, int B, int S, int L, int splits, int chunk,
                    int covgrad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L4 = L / 4;
  const int nv = (L4 + kGroup - 1) / kGroup;
#define SNIS_ARGS                                                              \
  static_cast<const float*>(h), static_cast<const float*>(beta),               \
      static_cast<const int*>(actions), static_cast<const float*>(log_q),      \
      static_cast<const float*>(rewards), static_cast<float*>(scores),         \
      static_cast<float*>(part), static_cast<float*>(grad), B, S, L, splits,   \
      chunk, covgrad != 0, st
  cudaError_t err;
  if (nv <= 1) err = launch_nv<1>(SNIS_ARGS);
  else if (nv <= 2) err = launch_nv<2>(SNIS_ARGS);
  else if (nv <= 4) err = launch_nv<4>(SNIS_ARGS);
  else if (nv <= 8) err = launch_nv<8>(SNIS_ARGS);
  else err = cudaErrorInvalidValue;
#undef SNIS_ARGS
  return (int)err;
}

const char* snis_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
