// Device helpers shared by the flash-attention forward
// (flash_attention_fwd.cu) and backward (flash_attention_bwd.cu)
// kernels: the constants, the tile geometry, the 16-byte loaders that
// upcast fp32 or bf16 rows into padded fp32 shared-memory rows, the
// output conversion, the shared-memory opt-in and the list of head
// widths. Each .cu includes it; the build hashes it with each source, so
// an edit here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the head widths with a kernel: X(16) X(32) ... for a case list
#define FLASH_HEAD_DIMS(X) X(16) X(32) X(64) X(128) X(256)

namespace {

constexpr float kNegInf = -2.0e38f;  // the reference kernel's own NEG_INF
constexpr int kBQ = 64;              // query rows per tile
constexpr int kThreads = 256;        // 16 x 16

template <int D>
struct TileShape {
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per tile
  static constexpr int SD = D + 4;               // row stride of the [rows][D] tiles (floats)
  static constexpr int SP = BK + 4;              // row stride of the [64][BK] tiles
  static constexpr int KC = BK / 16;             // score columns per thread
  static constexpr int OC = D / 16;              // output columns per thread
  static constexpr int VEC = OC >= 4 ? 4 : OC;   // output columns per shared read
};

// 16-byte words of the input type, upcast to fp32
__device__ __forceinline__ void unpack(const uint4& w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float* f, __nv_bfloat16) {
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);  // the lower address
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_out(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

// One R-row tile of D columns held in registers as 16-byte words: loaded
// from device memory (row r at base + r * stride elements; rows >= valid
// read as zeros), then stored to shared memory as fp32 rows of stride SD,
// times `mul`.
template <typename T, int D, int R>
struct TileRegs {
  static constexpr int EPW = 16 / (int)sizeof(T);  // elements per word
  static constexpr int WPR = D / EPW;              // words per row
  static constexpr int NW = R * WPR;
  static constexpr int PER = (NW + kThreads - 1) / kThreads;
  uint4 w[PER];

  __device__ __forceinline__ void load(const T* base, long stride, int valid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < NW) {
        const int r = e / WPR;
        const int c = e - r * WPR;
        w[i] = r < valid ? *reinterpret_cast<const uint4*>(base + r * stride + c * EPW)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  __device__ __forceinline__ void store(float* s, float mul) const {
    constexpr int SD = TileShape<D>::SD;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < NW) {
        const int r = e / WPR;
        const int c = e - r * WPR;
        float f[EPW];
        unpack(w[i], f, T());
        float* dst = s + r * SD + c * EPW;
#pragma unroll
        for (int q = 0; q < EPW; q += 4) {
          *reinterpret_cast<float4*>(dst + q) =
              make_float4(f[q] * mul, f[q + 1] * mul, f[q + 2] * mul, f[q + 3] * mul);
        }
      }
    }
  }
};

// raise a kernel's dynamic shared-memory limit once per device (the call
// costs host time), after which the flag is set
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
