// Exact top-K maximum-inner-product search streamed over the whole
// catalog, for Hopper (sm_90a), written by hand in CUDA C++ with a plain C
// interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/mips_topk/kernel.py:mips_topk_pallas.
//
// Computes, for each query row b: the K best (score, id) pairs over every
// catalog row i < P, score = q[b] . items[i], sorted in descending order
// (K <= 256). A row short of K items back-fills (-3e38f, -1), the
// reference's NEG_INF sentinel. The [B, P] score matrix is never stored.
//
// Bound. The function must read the catalog once (P * L * 4 bytes: 300 MB
// at P = 750,000, L = 100, i.e. 0.0896 ms at 3.35 TB/s) and do 2 B P L
// flops (4.8 GFLOP at B = 32): 0.0716 ms at the 67 TFLOP/s of fp32 FMAs,
// so a kernel that scores on the CUDA cores cannot reach the byte bound.
//
// What the design does about that bound:
//   * Scores run on the tensor cores in 3xTF32 (`mma.sync` m16n8k8, the
//     split of MmaF32 in flash_attention_common.cuh): each fp32 operand is
//     split into big = tf32(x), rounded to nearest, and small = x - big,
//     and a product is (small * big + big * small) + big * big, each term
//     in its own accumulator, added in IEEE fp32 at the end of a row: ~21
//     bits of each operand, within the fp32 gates of the plain version
//     (`ref.mips_topk_mma` emulates this arithmetic). Three passes at 495
//     TFLOP/s take ~0.03 ms: the bytes stay the bound.
//   * A block scores 32 queries (all of the training batch), so the
//     catalog is read from device memory once. Its 16 scoring warps form 4
//     teams of 4 (one warp of each on each of the SM's schedulers): team j
//     owns queries 8j..8j+7 (one n8 tile, whose split fragments it keeps
//     in registers for L <= 104), and warp s of a team
//     scores rows 16s..16s+15 of each 64-row tile (one m16 tile, read with
//     `ldmatrix`: a row stride of L = 100 floats puts the eight rows of an
//     ldmatrix phase on distinct banks).
//   * A 17th warp streams the catalog: a tile of 64 contiguous rows is one
//     run of bytes, one `cp.async.bulk` (TMA, 1-D) completing on an
//     `mbarrier`, into a ring of up to 4 stages, so three tiles are in
//     flight while one is scored. Each scoring warp releases a stage on
//     its "empty" mbarrier as soon as its products are done.
//   * A TPU grid runs in order and carries the running top-K between grid
//     steps; GPU blocks run in no order. So the catalog is cut into about
//     one chunk per SM (`mips_probe_kernel`), each block writes a sorted
//     partial top-K per query to a scratch buffer, and `mips_merge_kernel`
//     (a block per query) merges those partial lists.
//   * The running top-K of each query keeps its K-th score as a threshold
//     (topk_select.cuh): a candidate is appended to the query's buffer only
//     if it beats it; a buffer that could not take another tile is folded
//     by a radix select in one warp's registers. Appends and folds of a
//     team's 8 queries are ordered by a named barrier of that team's 128
//     threads per tile (`bar.red.or 1 + team`, which also tells whether an
//     append took a buffer past its fold line), and one more only when the
//     team folds; never by a block-wide one: a team that folds holds up
//     neither the other teams nor the copies. The team folds all 8 queries
//     at once (2 per warp), so they stall it together, not each on its own
//     tile. Each query's top-K is sorted once, at the end.
//   * A floor before the scan: two small kernels score every 92nd row (at
//     P 750,000; at most 8,192 rows) in fp32 and take each query's K-th
//     sampled score less a margin (`mips_floor_kernel`). At least K rows
//     score above it, so no row below it can be among the K best; the
//     probe's gate is the larger of its threshold and the floor, and a
//     block appends about K * 92 / 132 candidates a query instead of about
//     K (1 + ln(5,696 / K)).
//   * The merge (a block per query) stages the partial lists' first
//     ranks in shared memory in one round trip, then one warp reads them
//     rank by rank and stops at the first rank where no entry beats the
//     running K-th score: the lists are sorted, so no later entry can. It
//     reads a few ranks, not chunks * K entries.
//   * The catalog's ragged end is masked here (the copy takes the tile's
//     whole 16-byte words, the copy warp the last 0-3 floats); nothing is
//     padded or copied on the host. The ring is zeroed once, so the
//     columns past L that the last k-step reads are finite (their query
//     fragments are 0).
//
// Counting. Given a counters buffer, the launch runs the probe kernel's
// kCount instantiation (without one, the plain instantiation, whose code
// has none of this): the block counts its tiles, the appends, the folds
// and the scoring warps' cycles (the 32-bit clock) in four phases:
// waiting for a full stage; the products; the appends with the team's
// barrier; the folds with their barrier, and the last fold and sort. The
// clock is read at each phase's end; the products are what the other
// three phases leave of the warp's whole time. A lane keeps its appends
// and its waits in registers; each warp adds the append and fold cycles to
// its own slots in shared memory as it goes, every lane storing the same
// sum. At the end the block sums the warps' slots and adds each field to
// the buffer with one atomic (kCountFields int64, `CountField` order). On
// an H100 at the training cell's shape (B 4096, P 750,000, L 100, K 256)
// this costs 0.2-1.5 % of the probe kernel's time. Measured there too: the
// waits in shared memory as well, 1.5-2.9 %; the products summed too,
// 1.9-3.6 %; every count in registers, 3-19 % (spills in the product
// loop); a branch or a predicated reduction for lane 0 alone, 4-8 %; shared
// sums that all warps add to, 40 % (the appends serialised).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kScoreWarps = 16;                  // 4 teams x 4 strips
constexpr int kThreads = (kScoreWarps + 1) * 32;  // and the copy warp
constexpr int kTileQ = 32;                        // queries per block: 8 per team
constexpr int kTileItems = 64;                    // catalog rows per tile: 16 per strip
constexpr int kTop = 256;                         // top slots per query (K <= 256)
constexpr int kCap = 192;                         // append slots per query
constexpr int kSlots = kTop + kCap;
constexpr int kTopR = kTop / 32;                  // registers of the final sort
constexpr int kKReg = 13;                         // k-steps held in registers (L <= 104)
constexpr int kMaxStages = 4;
constexpr int kSampleRows = 64;                   // sampled rows per block of the sample kernel
constexpr int kSampleThreads = 256;
constexpr int kSampleMax = 8192;                  // sampled rows, at most
constexpr int kFloorThreads = 256;                // the floor kernel's block: 32 keys a thread
// the floor's margin: 2^-12 of the largest sum of |q_l x_l| over the sampled
// rows, 16 times a bound on how far the probe kernel's 3xTF32 score of a row
// and the sample kernel's fp32 one can differ (each within 2^-17 of that sum
// of the exact dot product at L <= 227)
constexpr float kMarginRel = 1.0f / 4096.0f;
constexpr int kMergeThreads = 256;
constexpr int kMergeCap = 256;                    // the merge's append slots
constexpr int kMergeRoom = 8192;                  // partial-list pairs the merge stages at once
constexpr int kScoreThreads = kScoreWarps * 32;
constexpr int kCountBarrier = 5;                  // the scoring warps' barrier (1-4: the teams')

// The fields of the counters buffer (kernel.py: COUNT_FIELDS).
enum CountField {
  kQueries,      // queries probed (added by each query group's first chunk)
  kTiles,        // 64-row tiles scored, by every block
  kAppends,      // candidates appended past the gate
  kFolds,        // a query's buffer folded during the scan (the last fold apart)
  kWaitCycles,   // scoring warps' cycles waiting for a full stage
  kProductCycles,  // ... in the products (the whole time less the other three)
  kAppendCycles,   // ... in the appends and the team's barrier after them
  kFoldCycles,     // ... in the folds, their barrier, and the last fold and sort
  kCountFields
};

// Bytes of one ring stage: 64 rows of L floats, 32 bytes of zeros that the
// last row's over-read finds, rounded to 128 bytes.
__host__ __device__ inline size_t stage_bytes(int L) {
  return ((size_t)kTileItems * L * sizeof(float) + 32 + 127) & ~(size_t)127;
}

__host__ __device__ inline size_t state_bytes() {
  return (size_t)kTileQ * kSlots * (sizeof(float) + sizeof(int));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and the bulk copy (TMA, 1-D)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's generic-proxy accesses to shared memory before
// later bulk copies (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the low 32 bits of the SM's cycle counter (a phase is far shorter than
// their wrap); %clock64 is read in fixed latency, %clock is not
__device__ __forceinline__ unsigned clock32() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c));
  return (unsigned)c;
}

// the cycles since `since`, added to the warp's slot `f` (every lane
// stores the same sum: no branch); returns the clock read
__device__ __forceinline__ unsigned add_cycles(unsigned* slots, int f, unsigned since) {
  const unsigned now = clock32();
  slots[f] += now - since;
  return now;
}

// a barrier of one team's 4 warps (ids 1-4; 0 is __syncthreads)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(128) : "memory");
}

// the same barrier, returning whether `p` held on any of the team's threads
__device__ __forceinline__ bool team_sync_or(int team, bool p) {
  unsigned any;
  asm volatile(
      "{\n"
      ".reg .pred pin, pout;\n"
      "setp.ne.u32 pin, %1, 0;\n"
      "bar.red.or.pred pout, %2, 128, pin;\n"
      "selp.u32 %0, 1, 0, pout;\n"
      "}\n"
      : "=r"(any)
      : "r"((unsigned)p), "r"(1 + team)
      : "memory");
  return any != 0;
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

// big: x rounded to tf32, to nearest with ties away from zero (add half of
// the 13 dropped bits to the magnitude, clear them); small = x - big,
// exact, whose low 13 bits the mma drops. Integer and fp32 adds only, as
// in MmaF32::split.
__device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (rows r0.., columns k0..k0+7) of a tile of rows of L
// floats: lane 4g + t gets (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// With L % 4 == 0 every row starts on 16 bytes and one `ldmatrix` on
// 32-bit elements reads it (a 16-byte "row" of four floats per lane).
template <bool kVec>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* tile, int L, int r0, int k0,
                                       int lane) {
  if constexpr (kVec) {
    const float* p = tile + (r0 + (lane & 15)) * L + k0 + (lane >> 4) * 4;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(smem_u32(p))
                 : "memory");
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float* p = tile + (r0 + g) * L + k0 + t;
    a[0] = __float_as_uint(p[0]);
    a[1] = __float_as_uint(p[8 * L]);
    a[2] = __float_as_uint(p[4]);
    a[3] = __float_as_uint(p[8 * L + 4]);
  }
}

// The split B fragments of k-steps [pass * kKReg, ...) for query row
// `qrow` (lane 4g + t: columns k0 + t and k0 + t + 4 of query g); columns
// past L and rows past B are 0.
__device__ __forceinline__ void load_queries(uint32_t (&bb)[kKReg][2], uint32_t (&bs)[kKReg][2],
                                             const float* __restrict__ q, int qrow, int B, int L,
                                             int pass, int lane) {
  const int t = lane & 3;
  const float* row = q + (size_t)(qrow < B ? qrow : 0) * L;
#pragma unroll
  for (int ks = 0; ks < kKReg; ++ks) {
    const int c = (pass * kKReg + ks) * 8 + t;
    const float x0 = (qrow < B && c < L) ? __ldg(row + c) : 0.f;
    const float x1 = (qrow < B && c + 4 < L) ? __ldg(row + c + 4) : 0.f;
    split(__float_as_uint(x0), bb[ks][0], bs[ks][0]);
    split(__float_as_uint(x1), bb[ks][1], bs[ks][1]);
  }
}

// grid (ceil(m / kSampleRows), ceil(B / kTileQ)), kSampleThreads threads.
// Block (x, y) scores the sampled catalog rows s * stride, s in [64 x, 64 x
// + 64) and below m, against queries [32 y, 32 y + 32) in fp32 FMAs, to
// samp[b * m + s], and writes the largest sum of |q_l x_l| over its rows,
// per query, to amax[b * gridDim.x + x]. Dynamic shared memory: the rows
// [64][L], then the queries [32][L | 1] (an odd stride: each lane's query
// row on its own bank).
__global__ void __launch_bounds__(kSampleThreads) mips_sample_kernel(
    const float* __restrict__ q, const float* __restrict__ items, float* __restrict__ samp,
    float* __restrict__ amax, int B, int L, int m, int stride) {
  extern __shared__ __align__(16) float xsm[];
  const int lq = L | 1;
  float* xs = xsm;
  float* qs = xs + kSampleRows * L;
  __shared__ unsigned amax_s[kTileQ];
  __shared__ float tile_s[kTileQ * (kSampleRows + 1)];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kSampleRows;
  const int q0 = blockIdx.y * kTileQ;
  // every copy in flight at once (cp.async), then one wait
  for (int e = tid; e < kSampleRows * L; e += kSampleThreads) {
    const int r = e / L, c = e - r * L;
    if (s0 + r < m) cp_async4(xs + e, items + (size_t)(s0 + r) * stride * L + c);
    else xs[e] = 0.f;
  }
  for (int e = tid; e < kTileQ * L; e += kSampleThreads) {
    const int r = e / L, c = e - r * L;
    if (q0 + r < B) cp_async4(qs + r * lq + c, q + (size_t)(q0 + r) * L + c);
    else qs[r * lq + c] = 0.f;
  }
  cp_async_commit();
  if (tid < kTileQ) amax_s[tid] = 0u;
  cp_async_wait<0>();
  __syncthreads();
  // this thread: query tid % 32 against rows tid / 32 + 8 j (a warp's rows
  // are one broadcast read)
  constexpr int kRows = kSampleRows / (kSampleThreads / 32);
  const int qq = tid & 31, r0 = tid >> 5;
  float acc[kRows], mag[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = mag[j] = 0.f;
  for (int c = 0; c < L; ++c) {
    const float qv = qs[qq * lq + c];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float x = xs[(r0 + 8 * j) * L + c];
      acc[j] = fmaf(qv, x, acc[j]);
      mag[j] = fmaf(fabsf(qv), fabsf(x), mag[j]);
    }
  }
  float mmax = 0.f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    tile_s[qq * (kSampleRows + 1) + r0 + 8 * j] = acc[j];
    if (s0 + r0 + 8 * j < m) mmax = fmaxf(mmax, mag[j]);
  }
  atomicMax(&amax_s[qq], __float_as_uint(mmax));  // non-negative floats order as their bits
  __syncthreads();
  // each query's 64 scores as one run of samp's row
  for (int e = tid; e < kTileQ * kSampleRows; e += kSampleThreads) {
    const int r = e / kSampleRows, c = e - r * kSampleRows;
    if (q0 + r < B && s0 + c < m)
      samp[(size_t)(q0 + r) * m + s0 + c] = tile_s[r * (kSampleRows + 1) + c];
  }
  if (tid < kTileQ && q0 + tid < B)
    amax[(size_t)(q0 + tid) * gridDim.x + blockIdx.x] = __uint_as_float(amax_s[tid]);
}

// grid (B), kFloorThreads threads. Block b finds T, the K-th largest of row
// b's m sampled scores (a radix select over the block's keys, two bits a
// round), and writes floor[b] = T - margin: at least K catalog rows (the
// sampled ones at or above T) score above it in the probe kernel too, so
// no row below it is among the K best. With fewer than K sampled rows
// there is no floor (NEG_INF).
__global__ void __launch_bounds__(kFloorThreads) mips_floor_kernel(
    const float* __restrict__ samp, const float* __restrict__ amax, float* __restrict__ floor_out,
    int m, int nx, int k) {
  constexpr int R = kSampleMax / kFloorThreads;
  constexpr int kW = kFloorThreads / 32;
  __shared__ int part[3][kW];
  __shared__ unsigned mag_s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (m < k) {
    if (tid == 0) floor_out[b] = NEG_INF_F;
    return;
  }
  unsigned key[R];  // 0 below every score's key: a slot past m
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int sr = r * kFloorThreads + tid;
    key[r] = sr < m ? order_key(samp[(size_t)b * m + sr]) : 0u;
  }
  float mag = 0.f;
  for (int x = tid; x < nx; x += kFloorThreads) mag = fmaxf(mag, amax[(size_t)b * nx + x]);
  if (tid == 0) mag_s = 0u;
  unsigned kth = 0;  // the largest key with at least k keys >= it
  for (int bit = 30; bit >= 0; bit -= 2) {
    const unsigned c1 = kth | (1u << bit), c2 = kth | (2u << bit), c3 = kth | (3u << bit);
    int n1 = 0, n2 = 0, n3 = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      n1 += key[r] >= c1;
      n2 += key[r] >= c2;
      n3 += key[r] >= c3;
    }
    n1 = __reduce_add_sync(0xffffffffu, n1);
    n2 = __reduce_add_sync(0xffffffffu, n2);
    n3 = __reduce_add_sync(0xffffffffu, n3);
    if (lane == 0) {
      part[0][warp] = n1;
      part[1][warp] = n2;
      part[2][warp] = n3;
    }
    __syncthreads();
    int t1 = 0, t2 = 0, t3 = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      t1 += part[0][w];
      t2 += part[1][w];
      t3 += part[2][w];
    }
    __syncthreads();  // `part` is rewritten next round
    kth = t3 >= k ? c3 : t2 >= k ? c2 : t1 >= k ? c1 : kth;
  }
  atomicMax(&mag_s, __float_as_uint(mag));
  __syncthreads();
  if (tid == 0) floor_out[b] = key_value(kth) - kMarginRel * __uint_as_float(mag_s);
}

// grid (chunks, ceil(B / kTileQ)), kThreads threads. Block (c, y) scores
// catalog rows [c * per_chunk, min(P, (c + 1) * per_chunk)) against
// queries [y * kTileQ, ...) and writes each query's top-K of that range,
// sorted, to part_s / part_i [B, chunks, K]. Dynamic shared memory: the
// ring (stages x stage_bytes(L)), then the slots' scores and ids. With
// kCount, it also adds its counts to `counters` (kCountFields).
template <bool kVec, bool kCount>
__global__ void __launch_bounds__(kThreads, 1) mips_probe_kernel(
    const float* __restrict__ q, const float* __restrict__ items,
    const float* __restrict__ floor_in, float* __restrict__ part_s, int* __restrict__ part_i,
    int B, int L, int P, int k, int per_chunk, int stages,
    unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t sb = stage_bytes(L);
  float* ts = reinterpret_cast<float*>(smem + stages * sb);  // [kTileQ][kSlots]
  int* ti = reinterpret_cast<int*>(ts + kTileQ * kSlots);    // [kTileQ][kSlots]
  __shared__ float theta[kTileQ], floor_s[kTileQ];
  __shared__ int cnt[kTileQ];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kTileQ;
  const int nq = min(kTileQ, B - q0);
  const int lo = blockIdx.x * per_chunk;
  const int hi = min(P, lo + per_chunk);
  const int ntiles = (hi - lo + kTileItems - 1) / kTileItems;

  {
    float4* z = reinterpret_cast<float4*>(smem);
    const int n4 = (int)(stages * sb / sizeof(float4));
    for (int e = tid; e < n4; e += kThreads) z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int e = tid; e < kTileQ * kSlots; e += kThreads) {
    ts[e] = NEG_INF_F;
    ti[e] = -1;
  }
  if (tid < kTileQ) {
    theta[tid] = NEG_INF_F;
    floor_s[tid] = q0 + tid < B ? floor_in[q0 + tid] : NEG_INF_F;
    cnt[tid] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kScoreWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the zeros land before any bulk copy into the ring
  __syncthreads();

  if (warp == kScoreWarps) {  // the copy warp: one lane issues every tile
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(&empty[s], ((t / stages) - 1) & 1);
        float* dst = reinterpret_cast<float*>(smem + s * sb);
        const int t0 = lo + t * kTileItems;
        const int n = min(kTileItems, hi - t0) * L;  // floats
        const int bulk = n & ~3;                     // whole 16-byte words
        const float* src = items + (size_t)t0 * L;
        for (int e = bulk; e < n; ++e) dst[e] = src[e];
        fence_proxy_async();
        mbar_arrive_tx(&full[s], (unsigned)bulk * sizeof(float));
        if (bulk > 0) bulk_copy(dst, src, (unsigned)bulk * sizeof(float), &full[s]);
      }
    }
    return;
  }

  // a team's warps sit on the SM's four schedulers (warp % 4), one each, so
  // a team that waits at its barrier or folds leaves every scheduler the
  // other teams' warps
  const int team = warp >> 2, strip = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int qa = team * 8 + 2 * tq;  // this lane's queries in the tile: qa, qa + 1
  const bool active = team * 8 < nq;
  const int npass = ((L + 7) / 8 + kKReg - 1) / kKReg;
  uint32_t bb[kKReg][2], bs[kKReg][2];
  if (active && npass == 1) load_queries(bb, bs, q, q0 + team * 8 + g, B, L, 0, lane);
  // kCount: each scoring warp's slots, in CountField order, which no other
  // warp touches until the end; the appends this lane made as a leader
  [[maybe_unused]] unsigned* counts = nullptr;
  [[maybe_unused]] unsigned* slots = nullptr;
  [[maybe_unused]] unsigned appended = 0;
  if constexpr (kCount) {
    __shared__ unsigned warp_counts[kScoreWarps * kCountFields];
    counts = warp_counts;
    slots = counts + warp * kCountFields;
    for (int f = 0; f < kCountFields; ++f) slots[f] = 0u;
  }
  // kCount: the clock at the current phase's start; this lane's wait cycles
  [[maybe_unused]] unsigned c0 = 0, waited = 0;
  if constexpr (kCount) {
    c0 = clock32();
    slots[kProductCycles] = 0u - c0;  // less the warp's start (the end adds the rest)
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % stages;
    const int t0 = lo + t * kTileItems;
    const int m = min(kTileItems, hi - t0);
    mbar_wait(&full[s], (t / stages) & 1);
    if constexpr (kCount) { const unsigned now = clock32(); waited += now - c0; c0 = now; }
    // big * big, small * big and big * small in three accumulators: three
    // chains of 13 mma, not one of 26
    float cm[4] = {0.f, 0.f, 0.f, 0.f}, ca[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      const float* tile = reinterpret_cast<const float*>(smem + s * sb);
      for (int pass = 0; pass < npass; ++pass) {
        if (npass > 1) load_queries(bb, bs, q, q0 + team * 8 + g, B, L, pass, lane);
#pragma unroll
        for (int ks = 0; ks < kKReg; ++ks) {
          const int k0 = (pass * kKReg + ks) * 8;
          if (k0 < L) {
            uint32_t a[4], ab[4], as[4];
            load_a<kVec>(a, tile, L, strip * 16, k0, lane);
#pragma unroll
            for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
            mma_tf32(ca, as, bb[ks][0], bb[ks][1]);
            mma_tf32(cb, ab, bs[ks][0], bs[ks][1]);
            mma_tf32(cm, ab, bb[ks][0], bb[ks][1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp has read the stage
    if constexpr (kCount) c0 = clock32();
    if (!active) continue;

    const float th0 = qa < nq ? fmaxf(theta[qa], floor_s[qa]) : 0.f;
    const float th1 = qa + 1 < nq ? fmaxf(theta[qa + 1], floor_s[qa + 1]) : 0.f;
    // accumulator i: row g + 8 (i >> 1), query qa + (i & 1); a tie with the
    // K-th score loses, as the earlier row wins a tie. The 8 lanes of a
    // query (lanes tq, tq + 4, ...) take their slots for both rows with
    // one atomicAdd.
    const unsigned mine = 0x11111111u << tq, below = (1u << lane) - 1u;
    bool crossed = false;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int qq = qa + o;
      const float th = o ? th1 : th0;
      const float s0 = (ca[o] + cb[o]) + cm[o], s1 = (ca[o + 2] + cb[o + 2]) + cm[o + 2];
      const int r0 = strip * 16 + g, r1 = r0 + 8;
      const bool w0 = qq < nq && r0 < m && s0 > th, w1 = qq < nq && r1 < m && s1 > th;
      const unsigned g0 = __ballot_sync(0xffffffffu, w0) & mine;
      const unsigned g1 = __ballot_sync(0xffffffffu, w1) & mine;
      const int n = __popc(g0) + __popc(g1);
      const int leader = __ffs(g0 | g1 | (1u << 31)) - 1;  // lane 31 when both are empty
      int base = 0;
      if (n && lane == leader) {
        base = atomicAdd(&cnt[qq], n);
        if constexpr (kCount) appended += n;
        // the one append that takes the count past the fold line
        crossed |= base <= kCap - kTileItems && base + n > kCap - kTileItems;
      }
      base = __shfl_sync(0xffffffffu, base, leader);
      if (w0) {
        const int pos = kTop + base + __popc(g0 & below);
        ts[qq * kSlots + pos] = s0;
        ti[qq * kSlots + pos] = t0 + r0;
      }
      if (w1) {
        const int pos = kTop + base + __popc(g0) + __popc(g1 & below);
        ts[qq * kSlots + pos] = s1;
        ti[qq * kSlots + pos] = t0 + r1;
      }
    }
    // the team's appends are done; when one of its buffers could not take
    // another tile, the team folds all 8 (2 per warp, at once: one stall of
    // the team instead of one per query), and waits for the folds before
    // its next appends. A tile that folds nothing needs no second barrier:
    // appends from two tiles only add to the counts.
    const bool fold = team_sync_or(team, crossed);
    if constexpr (kCount) c0 = add_cycles(slots, kAppendCycles, c0);
    if (fold) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int qq = team * 8 + strip * 2 + o;
        if (qq < nq) {
          if constexpr (kCount) {
            if (lane == 0 && cnt[qq] >= 1) atomicAdd(&slots[kFolds], 1u);
          }
          fold_if<kTopR, kCap>(ts + qq * kSlots, ti + qq * kSlots, &cnt[qq], &theta[qq], k, 1,
                               lane);
        }
      }
      team_sync(team);
      if constexpr (kCount) c0 = add_cycles(slots, kFoldCycles, c0);
    }
  }
  if constexpr (!kCount) {
    if (!active) return;
    // each owner warp: the last fold, one sort, the query's partial list
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int qq = team * 8 + strip * 2 + o;
      if (qq >= nq) continue;
      const size_t out = ((size_t)(q0 + qq) * gridDim.x + blockIdx.x) * k;
      write_top<kTopR, kCap>(ts + qq * kSlots, ti + qq * kSlots, &cnt[qq], &theta[qq], k, lane,
                             part_s + out, part_i + out);
    }
  } else {
    if (active) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int qq = team * 8 + strip * 2 + o;
        if (qq >= nq) continue;
        const size_t out = ((size_t)(q0 + qq) * gridDim.x + blockIdx.x) * k;
        write_top<kTopR, kCap>(ts + qq * kSlots, ti + qq * kSlots, &cnt[qq], &theta[qq], k,
                               lane, part_s + out, part_i + out);
      }
      c0 = add_cycles(slots, kFoldCycles, c0);
    }
    slots[kWaitCycles] += waited;
    __syncwarp();
    if (lane == 0)  // the products: the warp's whole time (c0 less its start) less the rest
      slots[kProductCycles] += c0 - slots[kWaitCycles] - slots[kAppendCycles] - slots[kFoldCycles];
    const unsigned warp_appends = __reduce_add_sync(0xffffffffu, appended);
    if (lane == 0) slots[kAppends] = warp_appends;
    // every scoring warp's slots are written (the copy warp is gone)
    asm volatile("bar.sync %0, %1;\n" ::"n"(kCountBarrier), "n"(kScoreThreads) : "memory");
    if (tid < kCountFields) {
      unsigned long long sum = tid == kTiles ? ntiles : tid == kQueries && blockIdx.x == 0 ? nq : 0;
      if (tid != kTiles && tid != kQueries)
        for (int w = 0; w < kScoreWarps; ++w) sum += counts[w * kCountFields + tid];
      if (sum) atomicAdd(&counters[tid], sum);
    }
  }
}

// grid (B), kMergeThreads threads. Block b merges row b's `lists` sorted
// partial lists of k entries into its top-K (`merge_lists`: staged in
// shared memory at once, read rank by rank, stopped at the first rank
// that adds nothing).
__global__ void __launch_bounds__(kMergeThreads) mips_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i, int lists, int k) {
  extern __shared__ __align__(16) float msmem[];
  float* ms = msmem;                                         // [kMergeRoom]
  int* mi = reinterpret_cast<int*>(ms + kMergeRoom);         // [kMergeRoom]
  float* ts = reinterpret_cast<float*>(mi + kMergeRoom);     // [kTop + kMergeCap]
  int* ti = reinterpret_cast<int*>(ts + kTop + kMergeCap);   // [kTop + kMergeCap]
  __shared__ int cnt, stop;
  __shared__ float theta;
  const size_t b = blockIdx.x;
  merge_lists<kTopR, kMergeCap>(part_s + b * lists * k, part_i + b * lists * k, lists, k, ms, mi,
                                kMergeRoom, ts, ti, &cnt, &theta, &stop, out_s + b * k,
                                out_i + b * k);
}

// Dynamic shared memory of the probe kernel (which = 0) at `stages` ring
// stages, of the merge kernel (1) and of the sample kernel (2), in bytes.
size_t smem_bytes(int L, int stages, int which) {
  if (which == 0) return (size_t)stages * stage_bytes(L) + state_bytes();
  if (which == 1) return ((size_t)kMergeRoom + kTop + kMergeCap) * (sizeof(float) + sizeof(int));
  return ((size_t)kSampleRows * L + (size_t)kTileQ * (L | 1)) * sizeof(float);
}

}  // namespace

extern "C" {

// Launches, on `stream`, the floor's two kernels (which & 1: every
// stride-th row sampled, m rows; scratch samp [B, m], amax [B, ceil(m /
// 64)], floor [B]), the probe kernel (which & 2) and the merge kernel
// (which & 4); returns cudaGetLastError(). A call launches all (7); one
// part alone times its share. part_s / part_i: scratch of B * chunks * k
// entries each. `counters` (kCountFields int64, or null) runs the probe
// kernel's counting instantiation, which adds into it.
int mips_topk_launch(const void* q, const void* items, void* part_s, void* part_i,
                     void* out_s, void* out_i, void* samp, void* amax, void* floor_buf, int B,
                     int L, int P, int k, int chunks, int per_chunk, int stages, int m,
                     int stride, void* counters, int which, void* stream) {
  if (k < 1 || k > kTop || stages < 1 || stages > kMaxStages || m < 1 || m > kSampleMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = L % 4 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* itf = static_cast<const float*>(items);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* fl = static_cast<float*>(floor_buf);
  cudaError_t err = cudaSuccess;
  if (which & 1) {
    const int nx = (m + kSampleRows - 1) / kSampleRows;
    const size_t smem2 = smem_bytes(L, stages, 2);
    err = ensure_smem(3, (const void*)mips_sample_kernel, smem2);
    if (err != cudaSuccess) return (int)err;
    mips_sample_kernel<<<dim3(nx, (B + kTileQ - 1) / kTileQ), kSampleThreads, smem2, st>>>(
        qf, itf, static_cast<float*>(samp), static_cast<float*>(amax), B, L, m, stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mips_floor_kernel<<<B, kFloorThreads, 0, st>>>(static_cast<const float*>(samp),
                                                   static_cast<const float*>(amax), fl, m, nx, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which & 2) {
    const size_t smem0 = smem_bytes(L, stages, 0);
    auto* cn = static_cast<unsigned long long*>(counters);
    // the plain instantiations (0, 1) or the counting ones (4, 5)
    using Probe = void (*)(const float*, const float*, const float*, float*, int*, int, int, int,
                           int, int, int, unsigned long long*);
    const Probe probe = cn ? (vec ? mips_probe_kernel<true, true> : mips_probe_kernel<false, true>)
                           : (vec ? mips_probe_kernel<true, false>
                                  : mips_probe_kernel<false, false>);
    err = ensure_smem((vec ? 0 : 1) + (cn ? 4 : 0), (const void*)probe, smem0);
    if (err != cudaSuccess) return (int)err;
    dim3 grid0(chunks, (B + kTileQ - 1) / kTileQ);
    probe<<<grid0, kThreads, smem0, st>>>(qf, itf, fl, ps, pi, B, L, P, k, per_chunk, stages, cn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which & 4) {
    const size_t smem1 = smem_bytes(L, stages, 1);
    err = ensure_smem(2, (const void*)mips_merge_kernel, smem1);
    if (err != cudaSuccess) return (int)err;
    mips_merge_kernel<<<B, kMergeThreads, smem1, st>>>(
        ps, pi, static_cast<float*>(out_s), static_cast<int*>(out_i), chunks, k);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* mips_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
