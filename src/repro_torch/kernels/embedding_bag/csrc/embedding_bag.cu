// EmbeddingBag, padded multi-hot gather-sum, for Hopper (sm_90a), written
// by hand in CUDA C++ with a plain C interface (bound from Python with
// ctypes).
//
// Replaces: repro/kernels/embedding_bag/kernel.py:embedding_bag_pallas.
//
// Computes, for each bag b: out[b] = the sum, in t order, of table[idx[b, t]]
// over the live ids (idx >= 0), accumulated in the table's dtype, as the TPU
// kernel's output block accumulates: in fp32 each add is an fp32 add; in
// bf16 each add is an fp32 add of two bf16 values rounded to bf16 (nearest
// even). Padding (id < 0) adds nothing; a bag with no live id is 0; an id
// >= V reads row V - 1, as the TPU kernel's clamped row block does, so the
// kernel never reads outside the table.
//
// Bound. The function must read each distinct live row once (D elements),
// the [B, T] int32 ids, and write the [B, D] output. It does one add per
// element of a live row: far below one operation per byte, so the kernel is
// bound by device-memory bytes. The rows are scattered over the table (at
// the DLRM shape, 40,000,000 rows of 512 bytes), so what counts is how many
// row reads are in flight at once.
//
// What the design does about that bound:
//   * A TPU grid carries the bag's sum from one grid step (one t) to the
//     next. Here one warp owns a (bag, column chunk) pair and walks t itself:
//     no atomics, and the adds happen in t order, so the result is the same
//     function, bit for bit, as the plain in-order loop (`ref.py`).
//   * Each lane owns N consecutive columns of the chunk (N = 4 when D is a
//     multiple of 4 and the table's rows start on 16-byte (fp32) or 8-byte
//     (bf16) boundaries, so a row is read as whole words; else N = 1, the
//     scalar path for D such as 18 or 1). A warp covers 32 * N columns; a
//     wider D takes several chunks, each its own warp.
//   * The bag's ids are read 32 at a time, coalesced, one per lane; a ballot
//     marks the live ones, so padding costs no row read, and the row ids are
//     broadcast with shuffles. kAhead live rows are loaded into registers
//     before any of them is added: kAhead independent row reads in flight per
//     warp, added afterwards in t order.
//   * Row offsets are 64-bit: at the DLRM shape idx * D reaches 5.12e9
//     elements, past int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block, one (bag, chunk) each
constexpr int kAhead = 8;   // live rows loaded before they are added
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// N elements of a row, from `p` (aligned to N elements when N > 1), as fp32.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&v)[N]);

template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float (&v)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                          float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(const __nv_bfloat16* p,
                                                          float (&v)[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_bits_to_float(w.x & 0xffffu);
  v[1] = bf16_bits_to_float(w.x >> 16);
  v[2] = bf16_bits_to_float(w.y & 0xffffu);
  v[3] = bf16_bits_to_float(w.y >> 16);
}

// acc += x in the table's dtype: fp32 as is, bf16 rounded after the add.
template <typename T>
__device__ __forceinline__ float accumulate(float acc, float x);

template <>
__device__ __forceinline__ float accumulate<float>(float acc, float x) {
  return acc + x;
}

template <>
__device__ __forceinline__ float accumulate<__nv_bfloat16>(float acc, float x) {
  return __bfloat162float(__float2bfloat16_rn(acc + x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // exact: x already holds a bf16 value
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     T* __restrict__ out, int B, int Tn, int V, int D, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)B * chunks) return;  // the whole warp leaves together
  const int b = (int)(item / chunks);
  const int col = ((int)(item % chunks) * 32 + lane) * N;  // this lane's first column
  const bool active = col < D;  // D is a multiple of N on the N > 1 path
  const int* bag = idx + (long long)b * Tn;

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;

  for (int t0 = 0; t0 < Tn; t0 += 32) {
    const int id = t0 + lane < Tn ? bag[t0 + lane] : -1;
    unsigned live = __ballot_sync(kFull, id >= 0);  // bit j: id t0 + j is live
    while (live) {  // warp-uniform
      int rows[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        rows[j] = -1;
        if (live) {  // warp-uniform
          const int src = __ffs(live) - 1;
          live &= live - 1;
          rows[j] = min(__shfl_sync(kFull, id, src), V - 1);
        }
      }
      float v[kAhead][N];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[j][i] = 0.0f;
        if (rows[j] >= 0 && active) {
          load_row<T, N>(table + (long long)rows[j] * D + col, v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (rows[j] >= 0) {
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] = accumulate<T>(acc[i], v[j][i]);
        }
      }
    }
  }

  if (active) {
    T* o = out + (long long)b * D + col;
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = from_float<T>(acc[i]);
  }
}

template <typename T, int N>
cudaError_t launch(const void* table, const int* idx, void* out, int B, int Tn, int V,
                   int D, cudaStream_t stream) {
  const int chunks = (D + 32 * N - 1) / (32 * N);
  const long long warps = (long long)B * chunks;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, N><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), B, Tn, V, D, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [V, D] (dtype 0 = fp32, 1 = bf16), idx [B, Tn] int32, out [B, D] of the
// table's dtype; vec = 4 for the word path (D % 4 == 0, rows aligned), else 1.
// Launches on `stream` and returns cudaGetLastError() (an invalid argument is
// cudaErrorInvalidValue).
int embedding_bag_launch(const void* table, const void* idx, void* out, int B, int Tn,
                         int V, int D, int dtype, int vec, void* stream) {
  if (B < 0 || Tn < 0 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || D % 4 != 0)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int* ids = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec == 4 ? launch<float, 4>(table, ids, out, B, Tn, V, D, s)
                   : launch<float, 1>(table, ids, out, B, Tn, V, D, s);
  } else if (dtype == 1) {
    err = vec == 4 ? launch<__nv_bfloat16, 4>(table, ids, out, B, Tn, V, D, s)
                   : launch<__nv_bfloat16, 1>(table, ids, out, B, Tn, V, D, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
