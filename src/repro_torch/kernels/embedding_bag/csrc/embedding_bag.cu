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
// row reads are in flight and how long a chain of round trips the longest
// bag waits through: with ragged bags the short ones finish early and the
// card drains on the long ones. The table's size does not count: 40,000,000
// rows time as 2,000,000 (tools/probe_embedding_bag.py).
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
//   * One round trip for the ids: a warp reads 128 of its bag's ids at once
//     (four a lane, coalesced; a longer bag takes more such rounds) and
//     lists the live ones, in t order and clamped to V - 1, in shared
//     memory with ballots. No row read waits on an id read after the first.
//   * Rows in two register batches of kBatch: the next batch's reads are
//     issued before the current batch is added, so kBatch to 2 kBatch rows
//     are in flight a warp at every moment. Deeper did not pay on an H100
//     at the DLRM shape (PERF.md, the K8 redesign): batches of 8 or 16
//     rows were slower, and so was a per-warp ring of 16 or 32 rows
//     streamed by `cp.async` into shared memory (16-byte copies; kept as
//     tools/embedding_bag_ring.cu) at every uniform shape but ragged bf16,
//     where 16 rows gained 3.8 %: more rows in flight lengthen every
//     row's queue, and the trip through shared memory adds latency to
//     each row.
//   * Row offsets are 64-bit: at the DLRM shape idx * D reaches 5.12e9
//     elements, past int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block, one (bag, chunk) each
constexpr int kIds = 128;   // ids a warp reads in one round trip, four a lane
constexpr int kBatch = 4;   // rows a register batch
constexpr unsigned kFull = 0xffffffffu;

// The bits of a lane's N elements of a row, in 32-bit words (a bf16
// scalar in the low half of one).
template <typename T, int N>
struct Bits {
  uint32_t w[(N * (int)sizeof(T) + 3) / 4];
};

template <typename T, int N>
__device__ __forceinline__ void load_bits(const T* p, Bits<T, N>& v) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = x.x; v.w[1] = x.y; v.w[2] = x.z; v.w[3] = x.w;
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = x.x; v.w[1] = x.y;
  } else if constexpr (sizeof(T) == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// Element i of the bits, as fp32.
template <typename T, int N>
__device__ __forceinline__ float element(const Bits<T, N>& v, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(v.w[i]);
  } else {
    const uint32_t w = v.w[i >> 1];
    return __uint_as_float((i & 1 ? w >> 16 : w & 0xffffu) << 16);
  }
}

// acc + x in the table's dtype: fp32 as is, bf16 rounded after the add.
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
  __shared__ int lists[kWarps][kIds];
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)B * chunks) return;  // the whole warp leaves together
  const int b = (int)(item / chunks);
  const int col = ((int)(item % chunks) * 32 + lane) * N;  // this lane's first column
  const bool active = col < D;  // D is a multiple of N on the N > 1 path
  const int* bag = idx + (long long)b * Tn;
  int* ids = lists[threadIdx.x >> 5];
  const unsigned lower = (1u << lane) - 1u;

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  Bits<T, N> v0[kBatch], v1[kBatch];
  // rows j0 .. j0 + kBatch - 1 of the list (those below n) into v
  auto load = [&](Bits<T, N> (&v)[kBatch], int j0, int n) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < n && active) {
        load_bits<T, N>(table + (long long)ids[j0 + j] * D + col, v[j]);
      }
    }
  };
  auto add = [&](const Bits<T, N> (&v)[kBatch], int j0, int n) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = accumulate<T>(acc[i], element<T, N>(v[j], i));
      }
    }
  };

  for (int t0 = 0; t0 < Tn; t0 += kIds) {
    int id[kIds / 32];
#pragma unroll
    for (int k = 0; k < kIds / 32; ++k) {
      const int t = t0 + 32 * k + lane;
      id[k] = t < Tn ? __ldg(bag + t) : -1;
    }
    int n = 0;  // live ids of the round, listed in t order
#pragma unroll
    for (int k = 0; k < kIds / 32; ++k) {
      const unsigned live = __ballot_sync(kFull, id[k] >= 0);
      if (id[k] >= 0) ids[n + __popc(live & lower)] = min(id[k], V - 1);
      n += __popc(live);
    }
    __syncwarp();
    load(v0, 0, n);
    for (int j = 0; j < n; j += 2 * kBatch) {  // warp-uniform
      load(v1, j + kBatch, n);
      add(v0, j, n);
      load(v0, j + 2 * kBatch, n);
      add(v1, j + kBatch, n);
    }
    __syncwarp();  // the list is read: the next round may overwrite it
  }

  if (active) {
    T* o = out + (long long)b * D + col;
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = from_float<T>(acc[i]);
  }
}

template <typename T, int N>
cudaError_t launch(const void* table, const int* idx, void* out, int B, int Tn, int V, int D,
                   cudaStream_t stream) {
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
