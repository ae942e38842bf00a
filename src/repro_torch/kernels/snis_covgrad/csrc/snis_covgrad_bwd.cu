// The backward of the fused FOPO step, a coefficient-weighted
// gather-reduce, for Hopper (sm_90a), written by hand in CUDA C++ with a
// plain C interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/snis_covgrad/backward.py:snis_covgrad_bwd_pallas
// (per-sample tiling) and :snis_covgrad_bwd_tiled_pallas (TS-row tiles);
// one function serves both, the TS tiling being the wrapper's padding.
//
// Computes grad_h[b] = sum_s select(a_bs >= 0, coeff_bs, 0) * beta[a_bs].
// A select, not a multiply: a dead lane adds nothing whatever its
// coefficient, a NaN included; its row is not even read.
//
// Bound. The same gathered rows as the forward, B * S * L * 4 bytes (12.8
// MB at B 32, S 1000, L 100: 3.8 us at 3.35 TB/s), plus the coefficients
// and actions; 2 L flops per row. Bound by bytes, read as scattered
// 400-byte rows.
//
// What the design does about that bound:
//   * Nothing [B, S, L]-shaped exists: each live row is read once as
//     16-byte words into registers and folded into the group's sum.
//   * Eight lanes share one sample; S is split across blocks, grid
//     (splits, B), so several hundred blocks keep reads in flight at
//     B = 32.
//   * No atomics: a block sums its 32 groups through shared memory in a
//     fixed order and writes one partial per (row, split);
//     `snis_bwd_finalize` adds the splits in order. The result does not
//     depend on scheduling.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr int kGroups = kThreads / kGroup;

// grid (splits, B). NV = 16-byte words per lane (L / 4 <= 8 * NV).
template <int NV>
__global__ void __launch_bounds__(kThreads) snis_bwd_kernel(
    const float* __restrict__ coeff, const int* __restrict__ actions,
    const float* __restrict__ beta, float* __restrict__ part, int S, int L,
    int chunk) {
  extern __shared__ __align__(16) float smem[];  // [kGroups][L]
  const int b = blockIdx.y, split = blockIdx.x;
  const int lo = split * chunk, hi = min(S, lo + chunk);
  const int tid = threadIdx.x, grp = tid / kGroup, gl = tid % kGroup;
  const int L4 = L >> 2;
  const float4* beta4 = reinterpret_cast<const float4*>(beta);
  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int s = lo + grp; s < hi; s += kGroups) {
    const size_t at = (size_t)b * S + s;
    const int a = actions[at];
    if (a < 0) continue;  // select: a dead lane adds nothing
    const float c = coeff[at];
    const float4* row = beta4 + (size_t)a * L4;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int f = gl + kGroup * v;
      if (f < L4) {
        const float4 x = __ldg(row + f);
        acc[v].x = fmaf(c, x.x, acc[v].x);
        acc[v].y = fmaf(c, x.y, acc[v].y);
        acc[v].z = fmaf(c, x.z, acc[v].z);
        acc[v].w = fmaf(c, x.w, acc[v].w);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int f = gl + kGroup * v;
    if (f < L4) reinterpret_cast<float4*>(smem + grp * L)[f] = acc[v];
  }
  __syncthreads();
  float* out = part + ((size_t)b * gridDim.x + split) * L;
  for (int l = tid; l < L; l += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += smem[g * L + l];
    out[l] = sum;
  }
}

// grid (B): grad_h[b] = sum over splits, in split order.
__global__ void __launch_bounds__(kThreads) snis_bwd_finalize(
    const float* __restrict__ part, float* __restrict__ grad, int splits, int L) {
  const int b = blockIdx.x;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < splits; ++j) sum += part[((size_t)b * splits + j) * L + l];
    grad[(size_t)b * L + l] = sum;
  }
}

template <int NV>
cudaError_t launch_nv(const float* coeff, const int* actions, const float* beta,
                      float* part, float* grad, int B, int S, int L, int splits,
                      int chunk, cudaStream_t st) {
  const size_t smem = (size_t)kGroups * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)snis_bwd_kernel<NV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  snis_bwd_kernel<NV><<<dim3(splits, B), kThreads, smem, st>>>(coeff, actions, beta, part,
                                                               S, L, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  snis_bwd_finalize<<<B, kThreads, 0, st>>>(part, grad, splits, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest L the kernel takes (a multiple of 4): 8 lanes x 8 words x 4.
int snis_bwd_max_dim(void) { return kGroup * 8 * 4; }

// Launches the backward on `stream`; returns cudaGetLastError(). `part`
// is scratch of B * splits * L floats.
int snis_bwd_launch(const void* coeff, const void* actions, const void* beta, void* part,
                    void* grad, int B, int S, int L, int splits, int chunk,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = (L / 4 + kGroup - 1) / kGroup;
#define SNIS_ARGS                                                            \
  static_cast<const float*>(coeff), static_cast<const int*>(actions),        \
      static_cast<const float*>(beta), static_cast<float*>(part),            \
      static_cast<float*>(grad), B, S, L, splits, chunk, st
  cudaError_t err;
  if (nv <= 1) err = launch_nv<1>(SNIS_ARGS);
  else if (nv <= 2) err = launch_nv<2>(SNIS_ARGS);
  else if (nv <= 4) err = launch_nv<4>(SNIS_ARGS);
  else if (nv <= 8) err = launch_nv<8>(SNIS_ARGS);
  else err = cudaErrorInvalidValue;
#undef SNIS_ARGS
  return (int)err;
}

const char* snis_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
