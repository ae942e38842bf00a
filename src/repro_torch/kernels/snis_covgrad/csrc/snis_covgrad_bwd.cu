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
// 400-byte rows, so by how many of them are in flight at once.
//
// What the design does about that bound:
//   * One launch. S is split across blocks, grid (splits, B); a block sums
//     its chunk into one partial per (row, split), and the last block of a
//     row to finish (a ticket: __threadfence, then an atomicAdd on the
//     row's counter, which that block resets to 0) adds the row's partials
//     in split order. No other atomics: the result does not depend on
//     scheduling, and every launch leaves the counters at 0.
//   * Every load before the first FMA. Eight lanes share one sample. A
//     block reads its chunk's actions and coefficients in one round trip
//     (a lane each, passed round the group by shuffles), then a group
//     issues the 16-byte words of all its live rows of a batch before it
//     adds any of them. Samples are added in the same order as when they
//     were read one at a time, so the bits do not change with the batch.
//   * Nothing [B, S, L]-shaped exists: each live row is read once into
//     registers and folded into the group's sum; a warp's four groups are
//     added by shuffles, the block's eight warps through shared memory,
//     in a fixed order.
//   * That register layout (8 lanes x at most 8 words) takes L a multiple
//     of 4 up to 256. Any other L takes the wide path, `snis_bwd_wide`:
//     one warp per sample, two rows at a time, a row read in 32-word
//     chunks (16-byte words where L is a multiple of 4, else 4-byte
//     words), the warp's sum in shared memory ([warps][L], each lane
//     touching only its own words), the warps added in order, and the
//     same single launch. Shared memory bounds L there: 8 warps up to
//     L 7,200, one warp up to about 58,000.

#include <cuda_runtime.h>
#include <stdint.h>

#include "snis_covgrad_wide.cuh"

using snis_wide::Word;
using snis_wide::wide_warps;
using snis_wide::zero_word;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr int kGroups = kThreads / kGroup;

__device__ __forceinline__ float fmaw(float c, float x, float acc) { return fmaf(c, x, acc); }
__device__ __forceinline__ float4 fmaw(float c, float4 x, float4 acc) {
  return make_float4(fmaf(c, x.x, acc.x), fmaf(c, x.y, acc.y), fmaf(c, x.z, acc.z),
                     fmaf(c, x.w, acc.w));
}

// The block's partial of row b (`own`, L floats in shared memory, column
// l written by thread l mod blockDim) goes to `part`; the row's last block
// adds the row's partials in split order into grad[b]. With one split the
// partial is the result. Called by every thread of the block.
__device__ __forceinline__ void finish_row(const float* own, float* __restrict__ part,
                                           float* __restrict__ grad, int* __restrict__ counters,
                                           int b, int split, int splits, int L) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  if (splits == 1) {
    for (int l = tid; l < L; l += blockDim.x) grad[(size_t)b * L + l] = own[l];
    return;
  }
  float* out = part + ((size_t)b * splits + split) * L;
  for (int l = tid; l < L; l += blockDim.x) out[l] = own[l];
  __threadfence();  // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counters + b, 1);
    last = ticket == splits - 1;
    if (last) counters[b] = 0;  // every block of the row has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* row = part + (size_t)b * splits * L;
  for (int l = tid; l < L; l += blockDim.x) {
    float sum = 0.f;
    for (int j = 0; j < splits; ++j) sum += __ldcg(row + (size_t)j * L + l);
    grad[(size_t)b * L + l] = sum;
  }
}

// grid (splits, B). NV = 16-byte words per lane (L / 4 <= 8 * NV). Group
// grp of block (split, b) adds the samples lo + grp + 32 j, j = 0, 1, ...
template <int NV>
__global__ void __launch_bounds__(kThreads) snis_bwd_kernel(
    const float* __restrict__ coeff, const int* __restrict__ actions,
    const float* __restrict__ beta, float* __restrict__ part, float* __restrict__ grad,
    int* __restrict__ counters, int S, int L, int chunk) {
  // samples a group reads before it adds any: 8 words a lane in flight
  // (16 at L > 128)
  constexpr int kBatch = NV >= 4 ? 2 : 8 / NV;
  extern __shared__ __align__(16) float smem[];  // [warps][L]
  const int b = blockIdx.y, split = blockIdx.x;
  const int lo = split * chunk, n = min(S, lo + chunk) - lo;
  const int tid = threadIdx.x, grp = tid / kGroup, gl = tid % kGroup, warp = tid >> 5;
  const int L4 = L >> 2;
  const float4* beta4 = reinterpret_cast<const float4*>(beta);
  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);

  // rounds of up to 8 samples a group: lane gl reads sample j = gl's
  // action and coefficient, the group passes them round
  for (int r = 0; r < n; r += kGroups * kGroup) {
    const int mine = r + grp + kGroups * gl;
    const size_t at = (size_t)b * S + lo + mine;
    const int a_mine = mine < n ? __ldg(actions + at) : -1;
    const float c_mine = mine < n ? __ldg(coeff + at) : 0.f;
    // samples of the warp's first group this round (warp-uniform)
    const int first = r + warp * (32 / kGroup);
    const int in_round = min(kGroup, max(0, (n - first + kGroups - 1) / kGroups));
    for (int j0 = 0; j0 < in_round; j0 += kBatch) {
      int a[kBatch];
      float c[kBatch];
      float4 x[kBatch][NV];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = (j0 + q) & (kGroup - 1);
        a[q] = __shfl_sync(0xffffffffu, a_mine, j, kGroup);
        c[q] = __shfl_sync(0xffffffffu, c_mine, j, kGroup);
        if (j0 + q >= kGroup) a[q] = -1;
        const float4* row = beta4 + (size_t)max(a[q], 0) * L4;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int f = gl + kGroup * v;
          x[q][v] = a[q] >= 0 && f < L4 ? __ldg(row + f) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (a[q] < 0) continue;  // select: a dead lane adds nothing
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = fmaw(c[q], x[q][v], acc[v]);
      }
    }
  }
  // the warp's four groups (lanes gl, gl + 8, gl + 16, gl + 24 hold the
  // same words) added by two shuffles, then the warps through shared memory
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int o = kGroup; o < 32; o <<= 1) {
      acc[v].x += __shfl_xor_sync(0xffffffffu, acc[v].x, o);
      acc[v].y += __shfl_xor_sync(0xffffffffu, acc[v].y, o);
      acc[v].z += __shfl_xor_sync(0xffffffffu, acc[v].z, o);
      acc[v].w += __shfl_xor_sync(0xffffffffu, acc[v].w, o);
    }
    const int f = gl + kGroup * v;
    if (grp == warp * (32 / kGroup) && f < L4)
      reinterpret_cast<float4*>(smem + warp * L)[f] = acc[v];
  }
  __syncthreads();
  // the block's sum in place of warp 0's: column l is read and written by
  // one thread only, the same one that hands it on in finish_row
  for (int l = tid; l < L; l += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += smem[w * L + l];
    smem[l] = sum;
  }
  finish_row(smem, part, grad, counters, b, split, gridDim.x, L);
}

// grid (splits, B), block 32 * warps. Any L: warp w of block (j, b) adds
// the live samples lo + w, lo + w + warps, ..., two at a time; lane owns
// the words lane + 32 k of the warp's sum in shared memory.
template <int VEC>
__global__ void __launch_bounds__(kThreads) snis_bwd_wide(
    const float* __restrict__ coeff, const int* __restrict__ actions,
    const float* __restrict__ beta, float* __restrict__ part, float* __restrict__ grad,
    int* __restrict__ counters, int S, int L, int chunk) {
  using W = typename Word<VEC>::T;
  constexpr int kUnroll = 4;  // words a lane reads from each of the two rows at once
  extern __shared__ __align__(16) float smem[];  // [warps][L]
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y, split = blockIdx.x;
  const int lo = split * chunk, n = min(S, lo + chunk) - lo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LW = L / VEC;
  const W* bw = reinterpret_cast<const W*>(beta);
  W* acc = reinterpret_cast<W*>(smem + (size_t)warp * L);
  for (int f = lane; f < LW; f += 32) acc[f] = zero_word<W>();
  // rounds of up to 32 samples a warp: lane i reads sample i's action and
  // coefficient, the warp passes them round
  for (int r = 0; r < n; r += 32 * warps) {
    const int mine = r + warp + warps * lane;
    const size_t at = (size_t)b * S + lo + mine;
    const int a_mine = mine < n ? __ldg(actions + at) : -1;
    const float c_mine = mine < n ? __ldg(coeff + at) : 0.f;
    const int in_round = min(32, max(0, (n - r - warp + warps - 1) / warps));
    for (int j = 0; j < in_round; j += 2) {
      const int a0 = __shfl_sync(0xffffffffu, a_mine, j);
      const float c0 = __shfl_sync(0xffffffffu, c_mine, j);
      int a1 = __shfl_sync(0xffffffffu, a_mine, (j + 1) & 31);
      const float c1 = __shfl_sync(0xffffffffu, c_mine, (j + 1) & 31);
      if (j + 1 >= in_round) a1 = -1;
      if (a0 < 0 && a1 < 0) continue;  // warp-uniform
      const W* r0 = bw + (size_t)max(a0, 0) * LW;
      const W* r1 = bw + (size_t)max(a1, 0) * LW;
      for (int f0 = lane; f0 < LW; f0 += 32 * kUnroll) {
        W x0[kUnroll], x1[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int f = f0 + 32 * u;
          x0[u] = a0 >= 0 && f < LW ? __ldg(r0 + f) : zero_word<W>();
          x1[u] = a1 >= 0 && f < LW ? __ldg(r1 + f) : zero_word<W>();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int f = f0 + 32 * u;
          if (f >= LW) break;
          W s = acc[f];
          if (a0 >= 0) s = fmaw(c0, x0[u], s);  // select: a dead lane adds nothing
          if (a1 >= 0) s = fmaw(c1, x1[u], s);
          acc[f] = s;
        }
      }
    }
  }
  __syncthreads();
  // the block's sum in place of warp 0's, as in snis_bwd_kernel
  for (int l = tid; l < L; l += blockDim.x) {
    float sum = 0.f;
    for (int g = 0; g < warps; ++g) sum += smem[(size_t)g * L + l];
    smem[l] = sum;
  }
  finish_row(smem, part, grad, counters, b, split, gridDim.x, L);
}

template <int NV>
cudaError_t launch_nv(const float* coeff, const int* actions, const float* beta, float* part,
                      float* grad, int* counters, int B, int S, int L, int splits, int chunk,
                      cudaStream_t st) {
  const size_t smem = (size_t)(kThreads / 32) * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)snis_bwd_kernel<NV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  snis_bwd_kernel<NV><<<dim3(splits, B), kThreads, smem, st>>>(coeff, actions, beta, part,
                                                               grad, counters, S, L, chunk);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_wide(const float* coeff, const int* actions, const float* beta, float* part,
                        float* grad, int* counters, int B, int S, int L, int splits, int chunk,
                        cudaStream_t st) {
  size_t smem = 0;
  const int warps = wide_warps((size_t)L, kThreads / 32, &smem);
  if (warps < 1) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)snis_bwd_wide<VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  snis_bwd_wide<VEC><<<dim3(splits, B), 32 * warps, smem, st>>>(coeff, actions, beta, part,
                                                                grad, counters, S, L, chunk);
  return cudaGetLastError();
}

// The backward at any L: the register layout where it holds L (unless
// `wide_only`), else the wide path.
int launch(const void* coeff, const void* actions, const void* beta, void* part, void* grad,
           void* counters, int B, int S, int L, int splits, int chunk, void* stream,
           bool wide_only) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = (L / 4 + kGroup - 1) / kGroup;
#define SNIS_ARGS                                                                  \
  static_cast<const float*>(coeff), static_cast<const int*>(actions),              \
      static_cast<const float*>(beta), static_cast<float*>(part),                  \
      static_cast<float*>(grad), static_cast<int*>(counters), B, S, L, splits, chunk, st
  cudaError_t err;
  if (L % 4) err = launch_wide<1>(SNIS_ARGS);
  else if (wide_only || nv > 8) err = launch_wide<4>(SNIS_ARGS);
  else if (nv <= 1) err = launch_nv<1>(SNIS_ARGS);
  else if (nv <= 2) err = launch_nv<2>(SNIS_ARGS);
  else if (nv <= 4) err = launch_nv<4>(SNIS_ARGS);
  else err = launch_nv<8>(SNIS_ARGS);
#undef SNIS_ARGS
  return (int)err;
}

}  // namespace

extern "C" {

// Launches the backward on `stream`, any L >= 1; returns
// cudaGetLastError(), or cudaErrorInvalidValue where one warp's sum
// exceeds the block's shared memory. `part` is scratch of
// B * splits * L floats; `counters` B ints, 0 (each launch leaves them 0).
int snis_bwd_launch(const void* coeff, const void* actions, const void* beta, void* part,
                    void* grad, void* counters, int B, int S, int L, int splits, int chunk,
                    void* stream) {
  return launch(coeff, actions, beta, part, grad, counters, B, S, L, splits, chunk, stream,
                false);
}

// The same through the wide path at every L: `chip_smoke.py` times it
// against the register layout at fopo-paper's L 100.
int snis_bwd_launch_wide(const void* coeff, const void* actions, const void* beta,
                         void* part, void* grad, void* counters, int B, int S, int L,
                         int splits, int chunk, void* stream) {
  return launch(coeff, actions, beta, part, grad, counters, B, S, L, splits, chunk, stream,
                true);
}

// The id of the CUDA-graph capture under way on `stream`, or 0 when none
// is: the wrapper's ticket counters belong to one capture, or to eager
// launches.
unsigned long long snis_bwd_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess)
    return 0;
  return status == cudaStreamCaptureStatusActive ? id : 0;
}

const char* snis_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
