// Masked top-K over the probed clusters' padded inverted lists, for Hopper
// (sm_90a), written by hand in CUDA C++ with a plain C interface (bound
// from Python with ctypes).
//
// Replaces: repro/kernels/ivf_topk/kernel.py:ivf_topk_pallas.
//
// Computes, for each query row b: the K best (score, id) pairs over every
// slot of the lists probe[b, 0..n_probe), where score = q[b] . emb[slot] and
// a padded slot (id -1) is dead. Scores come out sorted in descending
// order; a row short of K live candidates back-fills (-3e38f, -1), the
// same sentinel the reference uses. K <= 256.
//
// Bound. The function must read, per query row, n_probe * capp list ids
// and the embeddings of the live slots among them (4L bytes each): at most
// n_probe * capp * (4L + 4) bytes, plus the queries, the probe ids and the
// [B, K] outputs. It does ~2L flops per candidate, i.e. ~0.5 flop per byte,
// far below the card's balance point: the kernel is bound by device-memory
// bytes, never by arithmetic. At the serving shapes those bytes take a few
// microseconds, so what a call costs is its chain of dependent round trips
// to device memory and its launches; the design cuts both.
//
// What the design does:
//   * One launch per call. A block takes a range of up to 1024 slots of
//     one probed list (grid: n_probe * splits ranges per row, B rows) and
//     writes that range's top-K to a scratch buffer; the last block of a
//     row to finish takes a ticket (__threadfence, then an atomicAdd on the
//     row's counter, which that block resets to 0) and merges the row's
//     partial lists. The B merges run on B blocks at once, beside the
//     other rows' probes.
//   * Two round trips before the scores: a block loads its range's ids
//     (four per thread, all at once) and the query, compacts the live
//     slots in slot order (a warp ballot and a scan of the warps' counts),
//     then issues the copies of its live rows, two tiles of up to 40 KB,
//     before the first wait (`cp.async`, 16 bytes when L % 4 == 0, 8 when L
//     is even, else 4).
//     A range whose live rows fit two tiles (the serving shapes) is read in
//     one round trip at any L: at L 2304 a tile is 4 whole rows, not a
//     slice of 64 columns of each. A longer range streams two tiles ahead.
//     Only live rows are copied, so the bytes read follow the live slots,
//     as the bound counts them.
//   * Dot products from shared memory: G lanes per row (G grows with L,
//     up to a warp), each lane summing its columns in order, then a
//     butterfly of shuffles (every lane of the group gets the same sum).
//   * No sort per tile. The block's running top-K keeps its K-th score as
//     a threshold (topk_select.cuh): a candidate that beats it is appended
//     (one atomicAdd per warp), and one warp folds the buffer by a radix
//     select when it could not take another tile. The top-K is sorted
//     once, in one warp's registers, before it is written.
//   * The merge loads the row's partial lists into shared memory (up to
//     32 ranks at once, in one round trip), then one warp reads them
//     rank by rank, appends what beats the threshold, folds when the buffer
//     holds K entries or would overflow, and stops after the first rank
//     none of whose entries beats the threshold: the lists are sorted, so
//     no later entry can.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 1024;                  // list slots per block
constexpr int kIdsPerThread = kMaxChunk / kThreads;
constexpr int kStageBytes = 40 * 1024;           // one tile of live rows
constexpr int kStages = 2;
constexpr int kMaxTile = 256;                    // live rows per tile
constexpr int kCap = 256;                        // append slots of the running top-K
constexpr int kRowBytes = kStages * kStageBytes; // the rows' region, also the merge's

// The block's dynamic shared memory: the query (L floats, rounded to 4),
// the rows' region, the top-K slots (RT * 32 top slots, then kCap), the
// live slots and ids of the range.
struct Layout {
  int lq, slots;
  size_t q, rows, ts, ti, live_slot, live_id, bytes;
};

__host__ __device__ inline Layout layout(int L, int rt) {
  Layout y;
  y.lq = (L + 3) & ~3;
  y.slots = rt * 32 + kCap;
  y.q = 0;
  y.rows = (size_t)y.lq * sizeof(float);
  y.ts = y.rows + kRowBytes;
  y.ti = y.ts + (size_t)y.slots * sizeof(float);
  y.live_slot = y.ti + (size_t)y.slots * sizeof(int);
  y.live_id = y.live_slot + kMaxChunk * sizeof(int);
  y.bytes = y.live_id + kMaxChunk * sizeof(int);
  return y;
}

// Issue the copies of rows [j0, j0 + m) of the live list into a stage of
// row stride L floats, U floats a copy, committed as one group: this
// thread's copies e = tid + i * kThreads, walked as (row, word) with no
// division per copy.
template <int U>
__device__ void issue_tile(float* stage, const float* embs_c, const int* live_slot, int j0,
                           int m, int L) {
  const int wu = L / U;  // copies per row
  int r = threadIdx.x / wu;
  int c = threadIdx.x - r * wu;
  const int dr = kThreads / wu;
  const int dc = kThreads - dr * wu;
  for (int e = threadIdx.x; e < m * wu; e += kThreads) {
    float* dst = stage + r * L + c * U;
    const float* src = embs_c + (size_t)live_slot[j0 + r] * L + c * U;
    if constexpr (U == 4) cp_async16(dst, src);
    else if constexpr (U == 2) cp_async8(dst, src);
    else cp_async4(dst, src);
    r += dr;
    c += dc;
    if (c >= wu) {
      c -= wu;
      ++r;
    }
  }
  cp_async_commit();
}

// grid (n_probe * splits, B), kThreads threads. Block (j, b) takes slots
// [split * chunk, min(capp, (split + 1) * chunk)) of cluster
// probe[b, j / splits], writes that range's top-K to part_s / part_i
// [B, n_probe * splits, K], and the last block of row b merges the row's
// partial lists into out_s / out_i [B, K]. counters[b] is 0 between
// launches. U: floats per copy (4 when L % 4 == 0 and the rows and the
// query start on 16 bytes, 2 when L is even and they start on 8, else 1).
// T: live rows per tile.
template <int RT, int U>
__global__ void __launch_bounds__(kThreads, 2) ivf_topk_kernel(
    const float* __restrict__ q, const int* __restrict__ probe,
    const int* __restrict__ lists, const float* __restrict__ embs,
    float* __restrict__ part_s, int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i, int* __restrict__ counters,
    int L, int n_probe, int capp, int k, int splits, int chunk, int T, int G) {
  constexpr int kp = RT * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout y = layout(L, RT);
  float* qs = reinterpret_cast<float*>(smem + y.q);
  float* rows = reinterpret_cast<float*>(smem + y.rows);
  float* ts = reinterpret_cast<float*>(smem + y.ts);
  int* ti = reinterpret_cast<int*>(smem + y.ti);
  int* live_slot = reinterpret_cast<int*>(smem + y.live_slot);
  int* live_id = reinterpret_cast<int*>(smem + y.live_id);
  __shared__ int wcount[kIdsPerThread * kWarps];
  __shared__ int n_live, cnt, last, stop;
  __shared__ float theta;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int c = probe[b * n_probe + j / splits];
  const int lo = (j % splits) * chunk;
  const int hi = min(capp, lo + chunk);
  const float* embs_c = embs + (size_t)c * capp * L;
  const float* qrow = q + (size_t)b * L;

  // round trip 1: the query (cp.async, group 0) and the range's ids
  for (int e = tid; e < L / U; e += kThreads) {
    if constexpr (U == 4) cp_async16(qs + 4 * e, qrow + 4 * e);
    else if constexpr (U == 2) cp_async8(qs + 2 * e, qrow + 2 * e);
    else cp_async4(qs + e, qrow + e);
  }
  cp_async_commit();
  int idv[kIdsPerThread];
#pragma unroll
  for (int i = 0; i < kIdsPerThread; ++i) {
    const int s = lo + i * kThreads + tid;
    idv[i] = s < hi ? __ldg(lists + (size_t)c * capp + s) : -1;
  }
  for (int e = tid; e < y.slots; e += kThreads) {
    ts[e] = NEG_INF_F;
    ti[e] = -1;
  }
  if (tid == 0) {
    cnt = 0;
    theta = NEG_INF_F;
  }
  // the live slots in slot order: a ballot per (round i, warp), then an
  // exclusive scan of the counts in (i, warp) order by warp 0
  unsigned live_mask[kIdsPerThread];
#pragma unroll
  for (int i = 0; i < kIdsPerThread; ++i) {
    live_mask[i] = __ballot_sync(0xffffffffu, idv[i] >= 0);
    if (lane == 0) wcount[i * kWarps + warp] = __popc(live_mask[i]);
  }
  __syncthreads();
  if (warp == 0) {
    static_assert(kIdsPerThread * kWarps == 32, "one count per lane");
    const int v = wcount[lane];
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    wcount[lane] = incl - v;
    if (lane == 31) n_live = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kIdsPerThread; ++i) {
    if (idv[i] >= 0) {
      const int pos = wcount[i * kWarps + warp] + __popc(live_mask[i] & below);
      live_slot[pos] = lo + i * kThreads + tid;
      live_id[pos] = idv[i];
    }
  }
  __syncthreads();

  // round trip 2: the live rows, two tiles before the first wait
  const int n = n_live;
  const int ntiles = (n + T - 1) / T;
  const int stage_floats = kStageBytes / (int)sizeof(float);
  for (int t = 0; t < ntiles && t < kStages; ++t)
    issue_tile<U>(rows + t * stage_floats, embs_c, live_slot, t * T, min(T, n - t * T), L);
  const int per_warp = 32 / G;  // rows a warp scores at once
  const int gl = lane % G;      // this lane's place in its row's group
  for (int t = 0; t < ntiles; ++t) {
    // the query and tile t have landed (tile t + 1 may be in flight)
    if (t + 1 < ntiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const float* stage = rows + (t % kStages) * stage_floats;
    const int j0 = t * T;
    const int m = min(T, n - j0);
    const float th = theta;
    for (int r0 = 0; r0 < m; r0 += kWarps * per_warp) {
      const int r = r0 + warp * per_warp + lane / G;
      float acc = 0.f;
      if (r < m) {
        const float* row = stage + r * L;
        if constexpr (U == 4) {
          const float4* row4 = reinterpret_cast<const float4*>(row);
          const float4* q4 = reinterpret_cast<const float4*>(qs);
          for (int w = gl; w < L / 4; w += G) {
            const float4 a = row4[w], x = q4[w];
            acc = fmaf(x.x, a.x, acc);
            acc = fmaf(x.y, a.y, acc);
            acc = fmaf(x.z, a.z, acc);
            acc = fmaf(x.w, a.w, acc);
          }
        } else {
          for (int w = gl; w < L; w += G) acc = fmaf(qs[w], row[w], acc);
        }
      }
      for (int d = G / 2; d > 0; d >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, d);
      // a tie with the K-th score loses, as the earlier slot wins a tie
      const bool wins = r < m && gl == 0 && acc > th;
      const unsigned mask = __ballot_sync(0xffffffffu, wins);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&cnt, __popc(mask));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (wins) {
          const int pos = kp + base + __popc(mask & below);
          ts[pos] = acc;
          ti[pos] = live_id[j0 + r];
        }
      }
    }
    __syncthreads();  // the appends are done and the stage is read
    if (t + kStages < ntiles)
      issue_tile<U>(rows + (t % kStages) * stage_floats, embs_c, live_slot, (t + kStages) * T,
                    min(T, n - (t + kStages) * T), L);
    // fold a buffer that could not take another tile (the next barrier
    // waits for it)
    if (warp == 0) fold_if<RT, kCap>(ts, ti, &cnt, &theta, k, kCap - T + 1, lane);
  }
  cp_async_wait<0>();  // the query's copy, when no row was live
  __syncthreads();

  // the range's top-K, sorted, to the scratch buffer
  const int lists_per_row = gridDim.x;
  if (warp == 0) {
    const size_t out = ((size_t)b * lists_per_row + j) * k;
    write_top<RT, kCap>(ts, ti, &cnt, &theta, k, lane, part_s + out, part_i + out);
    __threadfence();  // the partial list is visible before the ticket
  }
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counters + b, 1);
    last = ticket == lists_per_row - 1;
    if (last) counters[b] = 0;  // every block of the row has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the merge, in the rows' region: scores in its first half, ids in its second
  merge_lists<RT, kCap>(part_s + (size_t)b * lists_per_row * k,
                        part_i + (size_t)b * lists_per_row * k, lists_per_row, k, rows,
                        reinterpret_cast<int*>(rows) + kRowBytes / 8, kRowBytes / 8, ts, ti, &cnt,
                        &theta, &stop, out_s + (size_t)b * k, out_i + (size_t)b * k);
}

template <int RT, int U>
cudaError_t launch(const void* q, const void* probe, const void* lists, const void* embs,
                   void* part_s, void* part_i, void* out_s, void* out_i, void* counters, int B,
                   int L, int n_probe, int capp, int k, int splits, int chunk, int T, int G,
                   cudaStream_t st) {
  const size_t smem = layout(L, RT).bytes;
  const void* fn = (const void*)ivf_topk_kernel<RT, U>;
  constexpr int which = (RT == 1 ? 0 : RT == 2 ? 1 : RT == 4 ? 2 : 3) * 3 + (U == 4 ? 2 : U == 2);
  cudaError_t err = ensure_smem(which, fn, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_probe * splits, B);
  ivf_topk_kernel<RT, U><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const int*>(probe),
      static_cast<const int*>(lists), static_cast<const float*>(embs),
      static_cast<float*>(part_s), static_cast<int*>(part_i), static_cast<float*>(out_s),
      static_cast<int*>(out_i), static_cast<int*>(counters), L, n_probe, capp, k, splits, chunk,
      T, G);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch_u(int rt, const void* q, const void* probe, const void* lists,
                     const void* embs, void* part_s, void* part_i, void* out_s, void* out_i,
                     void* counters, int B, int L, int n_probe, int capp, int k, int splits,
                     int chunk, int T, int G, cudaStream_t st) {
#define IVF_LAUNCH(R)                                                                        \
  launch<R, U>(q, probe, lists, embs, part_s, part_i, out_s, out_i, counters, B, L, n_probe, \
               capp, k, splits, chunk, T, G, st)
  switch (rt) {
    case 1: return IVF_LAUNCH(1);
    case 2: return IVF_LAUNCH(2);
    case 4: return IVF_LAUNCH(4);
    case 8: return IVF_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef IVF_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError().
// part_s / part_i: scratch of B * n_probe * splits * k entries each;
// counters: B ints, 0 (each launch leaves them 0). T live rows per tile
// (T * L * 4 <= 40 KB), G lanes per row (a power of two <= 32).
int ivf_topk_launch(const void* q, const void* probe, const void* lists,
                    const void* embs, void* part_s, void* part_i,
                    void* out_s, void* out_i, void* counters, int B, int L, int n_probe,
                    int capp, int k, int splits, int chunk, int T, int G, void* stream) {
  const int rt = next_pow2(k) > 32 ? next_pow2(k) / 32 : 1;
  if (k < 1 || rt > 8 || chunk > kMaxChunk || T < 1 || T > kMaxTile ||
      (size_t)T * L * sizeof(float) > kStageBytes || G < 1 || G > 32 || (G & (G - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row and the query to start on 16 bytes, 8-byte
  // ones on 8
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(embs);
  const int u = L % 4 == 0 && align % 16 == 0 ? 4 : L % 2 == 0 && align % 8 == 0 ? 2 : 1;
#define IVF_LAUNCH_U(UU)                                                                       \
  launch_u<UU>(rt, q, probe, lists, embs, part_s, part_i, out_s, out_i, counters, B, L, n_probe, \
               capp, k, splits, chunk, T, G, st)
  const cudaError_t err = u == 4 ? IVF_LAUNCH_U(4) : u == 2 ? IVF_LAUNCH_U(2) : IVF_LAUNCH_U(1);
#undef IVF_LAUNCH_U
  return (int)err;
}

// The id of the CUDA-graph capture under way on `stream`, or 0 when none
// is: the wrapper's ticket counters belong to one capture, or to eager
// launches.
unsigned long long ivf_topk_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess)
    return 0;
  return status == cudaStreamCaptureStatusActive ? id : 0;
}

const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
