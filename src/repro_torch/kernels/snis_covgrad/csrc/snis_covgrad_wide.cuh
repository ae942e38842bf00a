// The wide paths of the covgrad kernels (any L), shared by
// snis_covgrad_fwd.cu and snis_covgrad_bwd.cu: a row is read by one warp
// in 32-word chunks, a word being VEC floats (16 bytes where L is a
// multiple of 4, else 4 bytes), and a warp's per-column sums live in
// shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace snis_wide {

// A word: VEC floats, 16 bytes where L % 4 == 0, else 4 bytes.
template <int VEC> struct Word;
template <> struct Word<1> { using T = float; };
template <> struct Word<4> { using T = float4; };

template <class W> __device__ __forceinline__ W zero_word();
template <> __device__ __forceinline__ float zero_word<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero_word<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warps per block of a wide kernel whose warps each hold
// `per_warp_floats` of shared memory: `max_warps`, or fewer where they
// would not fit the block's opt-in limit; 0 if not even one fits. Sets
// `smem` to the bytes the block needs.
inline int wide_warps(size_t per_warp_floats, int max_warps, size_t* smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_warp = per_warp_floats * sizeof(float);
  size_t warps = (size_t)optin / per_warp;
  if (warps > (size_t)max_warps) warps = (size_t)max_warps;
  *smem = per_warp * warps;
  return (int)warps;
}

}  // namespace snis_wide
