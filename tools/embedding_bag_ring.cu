// K8's ring design, kept to be timed beside the shipped kernel
// (src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu); nothing
// in the package builds or calls it.
//
//     python3 tools/probe_embedding_bag.py \
//         --variant ring16=tools/embedding_bag_ring.cu:RING=16 \
//         --variant ring32=tools/embedding_bag_ring.cu:RING=32:RING_WARPS=4
//
// The same function as the shipped kernel, bit for bit: per bag the live
// rows (id >= 0) added in t order in the table's dtype (bf16 rounded after
// every add), an id >= V reads row V - 1, a bag with no live id gives 0.
// The same C entry, but only its word path at D a multiple of 128 (every
// other D, and vec 1, return cudaErrorInvalidValue).
//
// Design. One warp owns one (bag, 128-column chunk) pair. It reads 128 of
// the bag's ids in one round trip and lists the live ones in t order in
// shared memory with ballots, as the shipped kernel does. It then streams
// the listed rows' pieces by `cp.async.cg` (16 bytes a lane; a 512-byte
// fp32 piece is one warp-wide copy, a 256-byte bf16 piece half of one, so
// a bf16 copy moves two rows) into a per-warp ring of RING rows in
// dynamic shared memory, one commit group a copy: RING rows are in flight
// before the first add. The warp waits for the oldest group, adds its
// rows from shared memory in t order, and refills that slot with the row
// RING places ahead. Shared memory a block: RING_WARPS x RING x 512 bytes
// (fp32) or x 256 (bf16), plus 512 bytes a warp of ids.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RING
#define RING 16  // rows in flight a warp
#endif
#ifndef RING_WARPS
#define RING_WARPS 8  // warps a block
#endif

namespace {

constexpr int kWarps = RING_WARPS;
constexpr int kIds = 128;   // ids a warp reads in one round trip, four a lane
constexpr int kCols = 128;  // columns a warp owns, four a lane
constexpr unsigned kFull = 0xffffffffu;

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
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane's 4 elements of a row piece in shared memory, as fp32.
__device__ __forceinline__ void elements(const uint4* piece, int lane, const float*,
                                         float (&x)[4]) {
  const uint4 w = piece[lane];
  x[0] = __uint_as_float(w.x); x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z); x[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void elements(const uint4* piece, int lane, const __nv_bfloat16*,
                                         float (&x)[4]) {
  const uint2 w = reinterpret_cast<const uint2*>(piece)[lane];
  x[0] = __uint_as_float(w.x << 16); x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16); x[3] = __uint_as_float(w.y & 0xffff0000u);
}

template <typename T>
__host__ __device__ constexpr int words() {  // 16-byte words a piece
  return kCols * (int)sizeof(T) / 16;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_ring(const T* __restrict__ table, const int* __restrict__ idx,
                   T* __restrict__ out, int B, int Tn, int V, int D, int chunks) {
  constexpr int kWords = words<T>();  // 32 fp32, 16 bf16
  constexpr int kRows = 32 / kWords;  // rows a warp-wide copy moves: 1 fp32, 2 bf16
  constexpr int kStages = RING / kRows;
  static_assert(RING % kRows == 0 && kStages >= 1, "RING must hold whole copies");
  extern __shared__ uint4 ring_smem[];
  __shared__ int lists[kWarps][kIds];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)B * chunks) return;  // the whole warp leaves together
  const int b = (int)(item / chunks);
  const int col0 = (int)(item % chunks) * kCols;
  uint4* ring = ring_smem + (size_t)warp * RING * kWords;
  int* ids = lists[warp];
  const int* bag = idx + (long long)b * Tn;
  const unsigned lower = (1u << lane) - 1u;
  const int row_of_lane = lane / kWords, word_of_lane = lane % kWords;

  // copy stage st (rows st * kRows ..) of the list into its slot; one group
  // a stage, empty past the list's end
  auto issue = [&](int st, int n) {
    const int r = st * kRows + row_of_lane;
    if (r < n) {
      copy16(ring + ((st % kStages) * kRows + row_of_lane) * kWords + word_of_lane,
             table + (long long)ids[r] * D + col0 + word_of_lane * (16 / (int)sizeof(T)));
    }
    commit();
  };

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
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
    const int stages = (n + kRows - 1) / kRows;
    for (int st = 0; st < kStages; ++st) issue(st, n);
    for (int st = 0; st < stages; ++st) {  // warp-uniform
      wait_pending<kStages - 1>();  // this lane's copies of stage st have landed
      __syncwarp();                 // and every lane's
      const uint4* slot = ring + (st % kStages) * kRows * kWords;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (st * kRows + k < n) {
          float x[4];
          elements(slot + k * kWords, lane, static_cast<const T*>(nullptr), x);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = accumulate<T>(acc[i], x[i]);
        }
      }
      __syncwarp();  // the slot is read: refill it
      issue(st + kStages, n);
    }
    __syncwarp();  // the list is read: the next round may overwrite it
  }

  T* o = out + (long long)b * D + col0 + lane * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = from_float<T>(acc[i]);
}

template <typename T>
cudaError_t launch(const void* table, const int* idx, void* out, int B, int Tn, int V, int D,
                   cudaStream_t stream) {
  const int chunks = D / kCols;
  const long long blocks = ((long long)B * chunks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int smem = kWarps * RING * words<T>() * 16;
  cudaError_t err = cudaFuncSetAttribute(embedding_bag_ring<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  embedding_bag_ring<T><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), B, Tn, V, D, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shipped kernel's C entry; only vec 4 at D % 128 == 0 is taken.
int embedding_bag_launch(const void* table, const void* idx, void* out, int B, int Tn,
                         int V, int D, int dtype, int vec, void* stream) {
  if (B < 0 || Tn < 0 || V < 1 || D < 1 || vec != 4 || D % kCols != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int* ids = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(table, ids, out, B, Tn, V, D, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(table, ids, out, B, Tn, V, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
