// Exact top-K maximum-inner-product search streamed over the whole
// catalog, for Hopper (sm_90a), written by hand in CUDA C++ with a plain C
// interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/mips_topk/kernel.py:mips_topk_pallas.
//
// Computes, for each query row b: the K best (score, id) pairs over every
// catalog row i < P, score = q[b] . items[i] in fp32 FMAs (no TF32, no
// library GEMM), sorted in descending order. A row short of K items
// back-fills (-3e38f, -1), the reference's NEG_INF sentinel. The [B, P]
// score matrix is never stored.
//
// Bound. The function must read the catalog once (P * L * 4 bytes: 300 MB
// at P = 750,000, L = 100, i.e. 0.0896 ms at 3.35 TB/s) and do 2 B P L
// flops (4.8 GFLOP at B = 32, 0.0716 ms at 67 TFLOP/s fp32): at the
// training shape it is bound by bytes, with the arithmetic close behind.
//
// What the design does about that bound:
//   * Every block scores its catalog rows against a tile of 32 queries at
//     once (all of the training batch), so the catalog is read from device
//     memory once, not once per query. The rows stream through shared
//     memory in tiles of 64, copied with cp.async and double-buffered: the
//     next tile's loads are in flight while the current one is scored.
//   * A TPU grid runs in order and carries the running top-K between grid
//     steps; GPU blocks run in no order. So the catalog is cut into about
//     one chunk per SM (`mips_probe_kernel`), each block writes a sorted
//     partial top-K per query to a scratch buffer, and `mips_merge_kernel`
//     (one warp per query) merges those partial lists.
//   * The running top-K of each query keeps its K-th score as a threshold.
//     A candidate is appended to the query's buffer only if it beats it;
//     when the buffer is nearly full one warp folds it into the top-K and
//     raises the threshold. The fold does not sort: it finds the new K-th
//     score by a radix select over the scores' bits in the warp's
//     registers (32 rounds of a compare and a warp sum) and moves the
//     entries above it to the top-K slots. About K (1 + ln(n / K)) of a
//     block's n rows pass the threshold per query. Each query's top-K is
//     sorted once, at the end (bitonic, in registers: 16 pairs a lane at
//     K = 256, shuffles between lanes).
//   * The merge reads the partial lists rank by rank and stops at the
//     first rank where no entry beats the running K-th score: the lists
//     are sorted, so no later entry can. It reads a few ranks, not
//     chunks * K entries.
//   * Scoring keeps 4 queries x 2 rows of sums per thread and reads rows
//     as 16-byte words; the row stride L = 100 floats is 25 words, odd, so
//     eight neighbouring rows fall in distinct banks. The catalog's ragged
//     end is masked here; nothing is padded or copied on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-3.0e38f)

namespace {

constexpr int kThreads = 256;   // threads per block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 32;      // queries per probe block: 4 per warp
constexpr int kTileItems = 64;  // catalog rows per tile: 2 per lane

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Append slots of a query's buffer (beside its Kp top slots); at least two
// tiles of candidates, so one tile always fits after a merge check.
__host__ __device__ inline int buffer_cap(int kp) {
  return kp > 2 * kTileItems ? kp : 2 * kTileItems;
}

// Entries per query in the probe kernel's shared memory: top + buffer,
// rounded up to the power of two the sort runs on.
__host__ __device__ inline int probe_slots(int kp) { return next_pow2(kp + buffer_cap(kp)); }

// Entries of the merge kernel's running top-K per query: Kp sorted plus
// at least a warp's round of candidates.
__host__ __device__ inline int merge_slots(int kp) { return next_pow2(kp + 32 > 256 ? kp + 32 : 256); }

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a sorts before b: higher score first; equal scores by lower id, with a
// dead id (-1) after every live one
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && (unsigned)ia < (unsigned)ib);
}

// One pass (stage K, distance J) of a bitonic sort of the R * 32 pairs
// the warp holds in registers, element e = r * 32 + lane, into descending
// order. Distances below 32 pair lanes (shuffles); from 32 up they pair a
// lane's own registers. All indices are compile-time after unrolling, so
// the arrays stay in registers.
template <int R, int K, int J>
__device__ __forceinline__ void bitonic_pass(float (&s)[R], int (&id)[R], int lane) {
  if constexpr (J >= 32) {
    constexpr int JR = J / 32;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = r ^ JR;
      if (p > r) {
        const bool up = ((r * 32) & K) == 0;  // K > J >= 32: lane bits do not reach K
        const bool swap = up ? before(s[p], id[p], s[r], id[r]) : before(s[r], id[r], s[p], id[p]);
        if (swap) {
          const float ts = s[r]; s[r] = s[p]; s[p] = ts;
          const int ti = id[r]; id[r] = id[p]; id[p] = ti;
        }
      }
    }
  } else {
    const bool lower = (lane & J) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float os = __shfl_xor_sync(0xffffffffu, s[r], J);
      const int oi = __shfl_xor_sync(0xffffffffu, id[r], J);
      const bool up = ((r * 32 + lane) & K) == 0;
      const bool take = (lower == up) ? before(os, oi, s[r], id[r]) : before(s[r], id[r], os, oi);
      if (take) {
        s[r] = os;
        id[r] = oi;
      }
    }
  }
}

template <int R, int K, int J>
__device__ __forceinline__ void bitonic_stage(float (&s)[R], int (&id)[R], int lane) {
  bitonic_pass<R, K, J>(s, id, lane);
  if constexpr (J > 1) bitonic_stage<R, K, J / 2>(s, id, lane);
}

template <int R, int K = 2>
__device__ __forceinline__ void warp_sort_regs(float (&s)[R], int (&id)[R], int lane) {
  bitonic_stage<R, K, K / 2>(s, id, lane);
  if constexpr (K < R * 32) warp_sort_regs<R, K * 2>(s, id, lane);
}

// A float as a uint32 key that orders like the float (larger key, larger
// value), and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

// A query's R * 32 slots (kp top entries, then `count` appended ones)
// loaded into one warp's registers, element e = r * 32 + lane; the slots
// past the used ones read as dead (NEG_INF, -1).
template <int R>
__device__ __forceinline__ void load_slots(const float* s, const int* id, int used, int lane,
                                           float (&rs)[R], int (&ri)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const bool live = e < used;
    rs[r] = live ? s[e] : NEG_INF_F;
    ri[r] = live ? id[e] : -1;
  }
}

// Fold a query's buffer into its top-K without sorting (one warp): find
// the K-th largest score by a radix select over the scores' order keys
// (32 rounds of a compare and a warp sum), move the K entries above it
// (and enough of those equal to it, earlier slots first) to slots
// [0, k) in any order, clear [k, kp), and raise the threshold to that
// K-th score.
template <int R>
__device__ void select_query(float* s, int* id, int* count, float* theta, int k, int kp,
                             int lane) {
  float rs[R];
  int ri[R];
  load_slots<R>(s, id, kp + *count, lane, rs, ri);
  unsigned key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) key[r] = order_key(rs[r]);
  unsigned kth = 0;  // the largest key with at least k keys >= it
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = kth | (1u << bit);
    int c = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) c += key[r] >= cand;
    if (__reduce_add_sync(0xffffffffu, c) >= k) kth = cand;
  }
  int above = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) above += key[r] > kth;
  const int ties = k - __reduce_add_sync(0xffffffffu, above);
  const unsigned before_lane = (1u << lane) - 1u;
  int written = 0, ties_seen = 0;
  __syncwarp();  // every lane has read its slots before any is rewritten
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned eq = __ballot_sync(0xffffffffu, key[r] == kth);
    const bool keep =
        key[r] > kth || (key[r] == kth && ties_seen + __popc(eq & before_lane) < ties);
    ties_seen += __popc(eq);
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = written + __popc(kept & before_lane);
      s[pos] = rs[r];
      id[pos] = ri[r];
    }
    written += __popc(kept);
  }
  for (int e = k + lane; e < kp; e += 32) {
    s[e] = NEG_INF_F;
    id[e] = -1;
  }
  __syncwarp();
  if (lane == 0) {
    *theta = key_value(kth);
    *count = 0;
  }
  __syncwarp();
}

// Sort a query's slots in registers (bitonic), keep the first k in
// descending order and clear the rest: the query's final top-K.
template <int R>
__device__ void sort_query(float* s, int* id, int* count, int k, int kp, int lane) {
  float rs[R];
  int ri[R];
  load_slots<R>(s, id, kp + *count, lane, rs, ri);
  warp_sort_regs<R>(rs, ri, lane);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const bool keep = e < k;
    s[e] = keep ? rs[r] : NEG_INF_F;
    id[e] = keep ? ri[r] : -1;
  }
  __syncwarp();
  if (lane == 0) *count = 0;
  __syncwarp();
}

// Issue the cp.async copies of one tile (m rows from row r0) into a
// [kTileItems][Lp] buffer and commit them as one group.
__device__ void issue_tile(float* tile, const float* items, int r0, int m, int L, int Lp) {
  const float* src = items + (size_t)r0 * L;
  if (L == Lp) {  // rows are 16-byte aligned: 16-byte copies
    const int words = m * (L >> 2);
    for (int e = threadIdx.x; e < words; e += blockDim.x)
      cp_async16(tile + 4 * e, src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < m * L; e += blockDim.x) {
      const int r = e / L, c = e - r * L;
      cp_async4(tile + r * Lp + c, src + e);
    }
  }
  cp_async_commit();
}

// grid (chunks, ceil(B / kTileQ)). Block (c, y) scores catalog rows
// [c * per_chunk, min(P, (c + 1) * per_chunk)) against queries
// [y * kTileQ, ...) and writes each query's top-K of that range, sorted,
// to part_s / part_i [B, chunks, K].
template <int R>
__global__ void __launch_bounds__(kThreads) mips_probe_kernel(
    const float* __restrict__ q, const float* __restrict__ items,
    float* __restrict__ part_s, int* __restrict__ part_i,
    int B, int L, int P, int k, int kp, int per_chunk) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = round4(L);
  const int Lw = Lp >> 2;  // 16-byte words per row
  constexpr int slots = R * 32;  // == probe_slots(kp)
  const int cap = buffer_cap(kp);
  float* qs = smem;                                          // [kTileQ][Lp]
  float* tiles = qs + kTileQ * Lp;                           // [2][kTileItems][Lp]
  float* ts = tiles + 2 * kTileItems * Lp;                   // [kTileQ][slots]
  int* ti = reinterpret_cast<int*>(ts + kTileQ * slots);     // [kTileQ][slots]
  __shared__ float theta[kTileQ];
  __shared__ int cnt[kTileQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kTileQ;
  const int nq = min(kTileQ, B - q0);
  const int lo = blockIdx.x * per_chunk;
  const int hi = min(P, lo + per_chunk);

  for (int e = tid; e < kTileQ * Lp; e += kThreads) {
    const int r = e / Lp, c = e - r * Lp;
    qs[e] = (r < nq && c < L) ? q[(size_t)(q0 + r) * L + c] : 0.f;
  }
  if (L != Lp) {  // the pad columns are never copied into: zero them once
    for (int e = tid; e < 2 * kTileItems * (Lp - L); e += kThreads) {
      const int r = e / (Lp - L), c = L + e % (Lp - L);
      tiles[r * Lp + c] = 0.f;
    }
  }
  for (int e = tid; e < kTileQ * slots; e += kThreads) {
    ts[e] = NEG_INF_F;
    ti[e] = -1;
  }
  if (tid < kTileQ) {
    theta[tid] = NEG_INF_F;
    cnt[tid] = 0;
  }
  __syncthreads();

  const int n = max(0, hi - lo);
  const int ntiles = (n + kTileItems - 1) / kTileItems;
  if (ntiles > 0) issue_tile(tiles, items, lo, min(kTileItems, n), L, Lp);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const int t0 = lo + t * kTileItems;
    const int m = min(kTileItems, hi - t0);
    if (t + 1 < ntiles) {
      const int n0 = t0 + kTileItems;
      issue_tile(tiles + (buf ^ 1) * kTileItems * Lp, items, n0,
                 min(kTileItems, hi - n0), L, Lp);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: this thread's queries 4 * warp + r, rows lane and lane + 32
    const float4* t4 = reinterpret_cast<const float4*>(tiles + buf * kTileItems * Lp);
    float acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int w = 0; w < Lw; ++w) {
      const float4 a = t4[lane * Lw + w];
      const float4 c = t4[(lane + 32) * Lw + w];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = q4[(4 * warp + r) * Lw + w];
        acc[r][0] = fmaf(x.x, a.x, acc[r][0]);
        acc[r][0] = fmaf(x.y, a.y, acc[r][0]);
        acc[r][0] = fmaf(x.z, a.z, acc[r][0]);
        acc[r][0] = fmaf(x.w, a.w, acc[r][0]);
        acc[r][1] = fmaf(x.x, c.x, acc[r][1]);
        acc[r][1] = fmaf(x.y, c.y, acc[r][1]);
        acc[r][1] = fmaf(x.z, c.z, acc[r][1]);
        acc[r][1] = fmaf(x.w, c.w, acc[r][1]);
      }
    }
    // offer: a candidate joins its query's buffer only if it beats the
    // K-th score (a tie loses, as the earlier row wins a tie)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qq = 4 * warp + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = lane + 32 * c;
        if (qq < nq && row < m && acc[r][c] > theta[qq]) {
          const int pos = kp + atomicAdd(&cnt[qq], 1);
          ts[qq * slots + pos] = acc[r][c];
          ti[qq * slots + pos] = t0 + row;
        }
      }
    }
    __syncthreads();
    // fold the buffers that could not take another tile
    for (int qq = warp; qq < nq; qq += kWarps) {
      if (cnt[qq] > cap - kTileItems)
        select_query<R>(ts + qq * slots, ti + qq * slots, &cnt[qq], &theta[qq], k, kp, lane);
    }
    __syncthreads();  // the next iteration refills the buffer just scored
  }
  for (int qq = warp; qq < nq; qq += kWarps)
    sort_query<R>(ts + qq * slots, ti + qq * slots, &cnt[qq], k, kp, lane);
  __syncthreads();
  for (int e = tid; e < nq * k; e += kThreads) {
    const int qq = e / k, r = e - qq * k;
    const size_t out = ((size_t)(q0 + qq) * gridDim.x + blockIdx.x) * k + r;
    part_s[out] = ts[qq * slots + r];
    part_i[out] = ti[qq * slots + r];
  }
}

// grid (ceil(B / kWarps)), one warp per query row b. Merges the row's
// `lists` sorted partial lists of k entries, rank by rank, into its top-K
// (a select after each rank that added something, one sort at the end),
// and stops after the first rank none of whose entries beats the running
// K-th score: every later rank is below it, list by list.
template <int R>
__global__ void __launch_bounds__(kThreads) mips_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i, int B, int lists, int k, int kp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int slots = R * 32;  // == merge_slots(kp)
  __shared__ float theta[kWarps];
  __shared__ int cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // a whole warp; the kernel has no block barrier
  float* ts = smem + warp * 2 * slots;
  int* ti = reinterpret_cast<int*>(ts + slots);
  for (int e = lane; e < slots; e += 32) {
    ts[e] = NEG_INF_F;
    ti[e] = -1;
  }
  if (lane == 0) {
    theta[warp] = NEG_INF_F;
    cnt[warp] = 0;
  }
  __syncwarp();
  const int cap = slots - kp;
  const float* ps = part_s + (size_t)b * lists * k;
  const int* pi = part_i + (size_t)b * lists * k;
  for (int r = 0; r < k; ++r) {
    bool any = false;
    for (int g0 = 0; g0 < lists; g0 += 32) {
      const int g = g0 + lane;
      float sc = NEG_INF_F;
      int cid = -1;
      if (g < lists) {
        sc = ps[(size_t)g * k + r];
        cid = pi[(size_t)g * k + r];
      }
      const bool wins = cid >= 0 && sc > theta[warp];
      const unsigned mask = __ballot_sync(0xffffffffu, wins);
      if (mask == 0) continue;
      any = true;
      if (cnt[warp] + __popc(mask) > cap)
        select_query<R>(ts, ti, &cnt[warp], &theta[warp], k, kp, lane);
      const int pos = kp + cnt[warp] + __popc(mask & ((1u << lane) - 1u));
      if (wins) {
        ts[pos] = sc;
        ti[pos] = cid;
      }
      __syncwarp();
      if (lane == 0) cnt[warp] += __popc(mask);
      __syncwarp();
    }
    if (!any) break;
    select_query<R>(ts, ti, &cnt[warp], &theta[warp], k, kp, lane);  // a fresh threshold
  }
  sort_query<R>(ts, ti, &cnt[warp], k, kp, lane);
  for (int e = lane; e < k; e += 32) {
    out_s[(size_t)b * k + e] = ts[e];
    out_i[(size_t)b * k + e] = ti[e];
  }
}

// Raise a kernel's dynamic shared-memory limit on the current device when
// a launch needs more than it was last set to.
cudaError_t ensure_smem(int which, const void* fn, size_t bytes) {
  static size_t set_to[4][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= set_to[which][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) set_to[which][dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the probe (which = 0) and merge (1) kernels.
size_t mips_topk_smem_bytes(int L, int k, int which) {
  const int kp = next_pow2(k);
  if (which == 0)
    return (size_t)(kTileQ + 2 * kTileItems) * round4(L) * sizeof(float) +
           (size_t)kTileQ * probe_slots(kp) * (sizeof(float) + sizeof(int));
  return (size_t)kWarps * merge_slots(kp) * (sizeof(float) + sizeof(int));
}

int mips_topk_tile_items(void) { return kTileItems; }

// Launches both kernels on `stream`; returns cudaGetLastError().
// part_s / part_i: scratch of B * chunks * k entries each.
int mips_topk_launch(const void* q, const void* items, void* part_s, void* part_i,
                     void* out_s, void* out_i, int B, int L, int P, int k,
                     int chunks, int per_chunk, void* stream) {
  const int kp = next_pow2(k);
  const int r0 = probe_slots(kp) / 32, r1 = merge_slots(kp) / 32;
  if ((r0 != 8 && r0 != 16) || (r1 != 8 && r1 != 16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem0 = mips_topk_smem_bytes(L, k, 0);
  const size_t smem1 = mips_topk_smem_bytes(L, k, 1);
  const void* probe = r0 == 8 ? (const void*)mips_probe_kernel<8> : (const void*)mips_probe_kernel<16>;
  const void* merge = r1 == 8 ? (const void*)mips_merge_kernel<8> : (const void*)mips_merge_kernel<16>;
  cudaError_t err = ensure_smem(r0 == 8 ? 0 : 1, probe, smem0);
  if (err != cudaSuccess) return (int)err;
  err = ensure_smem(r1 == 8 ? 2 : 3, merge, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid0(chunks, (B + kTileQ - 1) / kTileQ);
  const float* qf = static_cast<const float*>(q);
  const float* itf = static_cast<const float*>(items);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  if (r0 == 8)
    mips_probe_kernel<8><<<grid0, kThreads, smem0, st>>>(qf, itf, ps, pi, B, L, P, k, kp, per_chunk);
  else
    mips_probe_kernel<16><<<grid0, kThreads, smem0, st>>>(qf, itf, ps, pi, B, L, P, k, kp, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid1 = (B + kWarps - 1) / kWarps;
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  if (r1 == 8)
    mips_merge_kernel<8><<<grid1, kThreads, smem1, st>>>(ps, pi, os, oi, B, chunks, k, kp);
  else
    mips_merge_kernel<16><<<grid1, kThreads, smem1, st>>>(ps, pi, os, oi, B, chunks, k, kp);
  return (int)cudaGetLastError();
}

const char* mips_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
