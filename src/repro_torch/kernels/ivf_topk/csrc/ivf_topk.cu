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
// same sentinel the reference uses.
//
// Bound. The function must read, per query row, n_probe * capp list ids
// and the embeddings of the live slots among them (4L bytes each): at most
// n_probe * capp * (4L + 4) bytes, plus the queries, the probe ids and the
// [B, K] outputs. It does ~2L flops per candidate, i.e. ~0.5 flop per byte,
// far below the card's balance point: the kernel is bound by device-memory
// bytes, never by arithmetic.
//
// What the design does about that bound:
//   * Nothing intermediate goes to device memory: neither the
//     [B, n_probe*capp, L] candidate tensor nor the [B, n_probe*capp] score
//     matrix exists. Each probed tile of T = 128 list slots is streamed
//     through shared memory once, in slices of up to 64 columns of L (a
//     stage: the 128 x 64 slice of the slots' embeddings and the query's
//     64 columns, 35 KB), and each thread carries its slot's dot product
//     from slice to slice in a register, in column order. The shared
//     memory a block needs stops growing with L past 64 (an LM hidden
//     width of 2304 streams 36 slices; SASRec's 50 is one slice, as
//     before the slicing), only with K.
//   * The copies are asynchronous (cp.async) and double-buffered: a block
//     issues every load of the next stage before it scores the current one,
//     so many loads are in flight per SM instead of one per thread. When L
//     is a multiple of 4 (and the rows start on 16-byte boundaries) a copy
//     moves 16 bytes, else 4.
//   * The build packs each list from the front, so its padded tail holds
//     no live slot. A block first finds the end of the live slots in its
//     range and copies no tile past it: the bytes read follow the live
//     slots, as the bound counts them (plus the dead rows of the last
//     partly live tile).
//   * A TPU grid runs in order and carries the running top-K between grid
//     steps; GPU blocks run in no order. So the work is split in two
//     kernels: `ivf_probe_kernel` runs one block per (row, probe, chunk of
//     the list), enough blocks to fill the 132 SMs even at a batch of 8,
//     and writes a partial top-K per block to a scratch buffer;
//     `ivf_merge_kernel` runs one block per row and merges the
//     n_probe * splits partial lists into the final K. The scratch buffer
//     is B * n_probe * splits * K * 8 bytes, small beside the list reads.
//     More splits fill more SMs but give the merge more candidates; the
//     wrapper balances the two (see `splits_for` in kernel.py).
//   * The running top-K of a block is held sorted in shared memory. A tile
//     of candidates touches it only when one of them beats the current
//     K-th score (a block-wide vote); then only the winners are appended
//     and one bitonic sort of (K padded to a power of two) + winners,
//     rounded up to a power of two, restores the order. The merge kernel
//     reads the sorted partial lists rank by rank, so the K-th score rises
//     early and most later tiles sort nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-3.0e38f)

namespace {

constexpr int kThreads = 128;  // threads per block == candidates per tile
constexpr int kMaxSlice = 64;  // columns of L per stage, at most

// How L is cut into stages.
struct Slicing {
  int sw;      // columns per slice: all of L up to kMaxSlice (the last may be short)
  int stride;  // row stride of a staged slice in shared memory, in floats
  int stage;   // floats of one stage buffer: the slots' slice, then the query's
};

// An L of at most 64 is one slice, staged as it lies in device memory
// (stride L): a tile's embeddings are one contiguous run, copied as such.
// A wider L is cut into slices of 64 columns, and the stride padded: with
// 4-byte copies a thread reads its row word by word, and an odd stride puts
// thread i's word l in bank (i * stride + l) % 32, distinct across the warp;
// with 16-byte copies it reads 16-byte words, and a stride of an odd number
// of them puts the 8 threads of each quarter-warp on distinct ones. A stage
// is a multiple of 4 floats, so both buffers start on 16 bytes.
__host__ __device__ inline Slicing slicing(int L, bool vec) {
  Slicing s;
  s.sw = L < kMaxSlice ? L : kMaxSlice;
  if (L <= kMaxSlice) s.stride = L;
  else s.stride = vec ? 4 * ((kMaxSlice / 4) | 1) : (kMaxSlice | 1);
  s.stage = ((kThreads * s.stride + 3) & ~3) + ((s.sw + 3) & ~3);
  return s;
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a sorts before b: higher score first; equal scores by lower id
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of n (a power of two) (score, id) pairs in shared memory,
// into descending order. Every thread of the block must call it.
__device__ void bitonic_sort_desc(float* s, int* id, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int x = i ^ j;
        if (x > i) {
          float si = s[i], sx = s[x];
          int ii = id[i], ix = id[x];
          bool swap = ((i & k) == 0) ? before(sx, ix, si, ii)
                                     : before(si, ii, sx, ix);
          if (swap) {
            s[i] = sx; s[x] = si;
            id[i] = ix; id[x] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Entries of a running top-K buffer: kp sorted entries plus up to one
// tile of winners, rounded up to the power of two the sort runs on.
__host__ __device__ inline int topk_buffer(int kp) { return next_pow2(kp + kThreads); }

// The block's running top-K: s[0..kp) / id[0..kp) sorted descending in
// buffers of topk_buffer(kp) entries, and a winner counter (zero between
// calls).
struct TopK {
  float* s;
  int* id;
  int* count;
  int k, kp;
};

__device__ void init_topk(const TopK& t) {
  for (int e = threadIdx.x; e < t.kp; e += blockDim.x) {
    t.s[e] = NEG_INF_F;
    t.id[e] = -1;
  }
  if (threadIdx.x == 0) *t.count = 0;
}

// Offer one candidate per thread (cand_id -1: nothing) to the running
// top-K. Every thread of the block must call it; it sorts only when some
// candidate beats the K-th score, and then only the winners join.
__device__ void offer(const TopK& t, float cand_s, int cand_id) {
  // a tie with the K-th entry loses, as the earlier position wins a tie in
  // the reference's top-K
  const bool wins = cand_id >= 0 && cand_s > t.s[t.k - 1];
  if (!__syncthreads_or(wins)) return;
  if (wins) {
    const int pos = t.kp + atomicAdd(t.count, 1);
    t.s[pos] = cand_s;
    t.id[pos] = cand_id;
  }
  __syncthreads();
  const int used = t.kp + *t.count;
  const int n = next_pow2(used);
  for (int e = used + threadIdx.x; e < n; e += blockDim.x) {
    t.s[e] = NEG_INF_F;
    t.id[e] = -1;
  }
  __syncthreads();
  bitonic_sort_desc(t.s, t.id, n);
  // every thread read the count before the sort's barriers; the next
  // offer's vote orders this reset before its first atomicAdd
  if (threadIdx.x == 0) *t.count = 0;
}

// The copies of a slice of m rows, wu copies each, to rows of stride S:
// this thread's copies e = threadIdx.x + i * blockDim.x, walked as (row,
// column) with no division per copy.
template <bool kVec>
__device__ void issue_rows(float* buf, int S, const float* embs_c, int t0, int m, int l0,
                           int wu, int L) {
  constexpr int U = kVec ? 4 : 1;
  int r = threadIdx.x / wu;
  int c = threadIdx.x - r * wu;
  const int dr = blockDim.x / wu;
  const int dc = blockDim.x - dr * wu;
  for (int e = threadIdx.x; e < m * wu; e += blockDim.x) {
    float* dst = buf + r * S + c * U;
    const float* src = embs_c + (size_t)(t0 + r) * L + l0 + c * U;
    if (kVec) cp_async16(dst, src);
    else cp_async4(dst, src);
    r += dr;
    c += dc;
    if (c >= wu) {
      c -= wu;
      ++r;
    }
  }
}

// Issue the cp.async copies of one stage: columns [l0, l0 + w) of the m
// slots from t0, and the same columns of the query, committed as one group.
template <bool kVec>
__device__ void issue_stage(float* buf, const Slicing& sl, const float* embs_c,
                            const float* qrow, int t0, int m, int l0, int w, int L) {
  constexpr int U = kVec ? 4 : 1;  // floats per copy
  const int S = sl.stride;
  const int wu = w / U;  // copies per row (w is a multiple of 4 with 16-byte copies)
  float* qbuf = buf + ((kThreads * S + 3) & ~3);
  if (S == L) {  // one slice: the tile is one contiguous run
    const float* src = embs_c + (size_t)t0 * L;
    for (int e = threadIdx.x; e < m * wu; e += blockDim.x) {
      if (kVec) cp_async16(buf + e * U, src + e * U);
      else cp_async4(buf + e * U, src + e * U);
    }
  } else {
    issue_rows<kVec>(buf, S, embs_c, t0, m, l0, wu, L);
  }
  if (threadIdx.x < wu) {
    if (kVec) cp_async16(qbuf + U * threadIdx.x, qrow + l0 + U * threadIdx.x);
    else cp_async4(qbuf + threadIdx.x, qrow + l0 + threadIdx.x);
  }
  cp_async_commit();
}

// Carry this thread's dot product over the w staged columns of its slot,
// in column order (the same order at any slicing).
template <bool kVec>
__device__ __forceinline__ float slice_dot(const float* buf, const Slicing& sl, int w,
                                           float acc) {
  const float* row = buf + threadIdx.x * sl.stride;
  const float* qs = buf + ((kThreads * sl.stride + 3) & ~3);
  if (kVec) {
    for (int c = 0; c < w; c += 4) {
      const float4 r = *reinterpret_cast<const float4*>(row + c);
      const float4 q = *reinterpret_cast<const float4*>(qs + c);
      acc = fmaf(q.x, r.x, acc);
      acc = fmaf(q.y, r.y, acc);
      acc = fmaf(q.z, r.z, acc);
      acc = fmaf(q.w, r.w, acc);
    }
  } else {
    for (int c = 0; c < w; ++c) acc = fmaf(qs[c], row[c], acc);
  }
  return acc;
}

// grid (n_probe * splits, B). Block (j, b) scores list slots
// [split * chunk, min(capp, (split + 1) * chunk)) of cluster probe[b, j / splits]
// and writes that range's top-K to part_s / part_i [B, n_probe * splits, K].
template <bool kVec>
__global__ void ivf_probe_kernel(
    const float* __restrict__ q, const int* __restrict__ probe,
    const int* __restrict__ lists, const float* __restrict__ embs,
    float* __restrict__ part_s, int* __restrict__ part_i,
    int L, int n_probe, int capp, int k, int kp, int splits, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const Slicing sl = slicing(L, kVec);
  float* stages = smem;                                        // [2][sl.stage]
  float* ts = stages + 2 * sl.stage;                           // top-K scores
  int* ti = reinterpret_cast<int*>(ts + topk_buffer(kp));      // top-K ids
  __shared__ int count, live_end;
  const TopK top{ts, ti, &count, k, kp};

  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int c = probe[b * n_probe + j / splits];
  const int lo = (j % splits) * chunk;
  const int hi = min(capp, lo + chunk);
  const float* embs_c = embs + (size_t)c * capp * L;
  const int* ids_c = lists + (size_t)c * capp;
  const float* qrow = q + (size_t)b * L;

  init_topk(top);
  if (threadIdx.x == 0) live_end = lo;
  __syncthreads();
  // one past the last live slot of the range: no tile past it is copied
  int end = lo;
  for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) {
    if (ids_c[s] >= 0) end = s + 1;
  }
  atomicMax(&live_end, end);
  __syncthreads();
  end = live_end;

  // stage g is slice g % nsl of tile g / nsl
  const int nsl = (L + sl.sw - 1) / sl.sw;
  const int nstages = (end - lo + kThreads - 1) / kThreads * nsl;
  if (nstages > 0)
    issue_stage<kVec>(stages, sl, embs_c, qrow, lo, min(kThreads, end - lo), 0, sl.sw, L);
  int cid = -1;
  float acc = 0.f;
  for (int g = 0; g < nstages; ++g) {
    const int t = g / nsl;
    const int s = g - t * nsl;
    const int t0 = lo + t * kThreads;
    const int m = min(kThreads, end - t0);
    if (s == 0) {
      cid = threadIdx.x < m ? ids_c[t0 + threadIdx.x] : -1;
      acc = 0.f;
    }
    if (g + 1 < nstages) {
      const int t1 = (g + 1) / nsl;
      const int l1 = ((g + 1) - t1 * nsl) * sl.sw;
      const int n0 = lo + t1 * kThreads;
      issue_stage<kVec>(stages + ((g + 1) & 1) * sl.stage, sl, embs_c, qrow, n0,
                        min(kThreads, end - n0), l1, min(sl.sw, L - l1), L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (cid >= 0) {
      const int l0 = s * sl.sw;
      acc = slice_dot<kVec>(stages + (g & 1) * sl.stage, sl, min(sl.sw, L - l0), acc);
    }
    if (s == nsl - 1) offer(top, cid >= 0 ? acc : NEG_INF_F, cid);
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

  const size_t out = ((size_t)b * gridDim.x + j) * k;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    part_s[out + e] = ts[e];
    part_i[out + e] = ti[e];
  }
}

// grid (B). Merges row b's p sorted partial lists of k entries into its
// top-K, reading them rank by rank (rank 0 of every list first).
__global__ void ivf_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i, int p, int k, int kp) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;
  int* ti = reinterpret_cast<int*>(ts + topk_buffer(kp));
  __shared__ int count;
  const TopK top{ts, ti, &count, k, kp};
  const int b = blockIdx.x;
  init_topk(top);
  __syncthreads();
  const int m = p * k;
  const float* ps = part_s + (size_t)b * m;
  const int* pi = part_i + (size_t)b * m;
  for (int t0 = 0; t0 < m; t0 += kThreads) {
    const int e = t0 + threadIdx.x;
    float sc = NEG_INF_F;
    int cid = -1;
    if (e < m) {
      const int at = (e % p) * k + e / p;  // list e % p, rank e / p
      cid = pi[at];
      sc = ps[at];
    }
    offer(top, sc, cid);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_s[(size_t)b * k + e] = ts[e];
    out_i[(size_t)b * k + e] = ti[e];
  }
}

// Raise a kernel's dynamic shared-memory limit on the current device when
// a launch needs more than it was last set to (the call costs host time,
// so it is made once per new maximum, not once per launch).
cudaError_t ensure_smem(int which, const void* fn, size_t bytes) {
  static size_t set_to[3][64] = {};
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

// Dynamic shared memory of the probe kernel with 4-byte (which = 0) or
// 16-byte (2) copies and of the merge kernel (1), in bytes; the caller
// checks it against the card's limit. L is streamed in slices of at most
// 64 columns, so it stops growing with L past 64.
size_t ivf_topk_smem_bytes(int L, int k, int which) {
  const size_t topk = (size_t)topk_buffer(next_pow2(k)) * (sizeof(float) + sizeof(int));
  if (which == 1) return topk;
  return topk + 2 * (size_t)slicing(L, which == 2).stage * sizeof(float);
}

int ivf_topk_threads(void) { return kThreads; }

// Launches both kernels on `stream` and returns cudaGetLastError().
// part_s / part_i: scratch of B * n_probe * splits * k entries each.
int ivf_topk_launch(const void* q, const void* probe, const void* lists,
                    const void* embs, void* part_s, void* part_i,
                    void* out_s, void* out_i, int B, int L, int n_probe,
                    int capp, int k, int splits, int chunk, void* stream) {
  const int kp = next_pow2(k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row and the query to start on 16 bytes
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(embs) % 16 == 0;
  const size_t smem0 = ivf_topk_smem_bytes(L, k, vec ? 2 : 0);
  const size_t smem1 = ivf_topk_smem_bytes(L, k, 1);
  const void* probe_fn = vec ? (const void*)ivf_probe_kernel<true>
                             : (const void*)ivf_probe_kernel<false>;
  cudaError_t err = ensure_smem(vec ? 2 : 0, probe_fn, smem0);
  if (err != cudaSuccess) return (int)err;
  err = ensure_smem(1, (const void*)ivf_merge_kernel, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid0(n_probe * splits, B);
  if (vec) {
    ivf_probe_kernel<true><<<grid0, kThreads, smem0, st>>>(
        static_cast<const float*>(q), static_cast<const int*>(probe),
        static_cast<const int*>(lists), static_cast<const float*>(embs),
        static_cast<float*>(part_s), static_cast<int*>(part_i), L, n_probe,
        capp, k, kp, splits, chunk);
  } else {
    ivf_probe_kernel<false><<<grid0, kThreads, smem0, st>>>(
        static_cast<const float*>(q), static_cast<const int*>(probe),
        static_cast<const int*>(lists), static_cast<const float*>(embs),
        static_cast<float*>(part_s), static_cast<int*>(part_i), L, n_probe,
        capp, k, kp, splits, chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ivf_merge_kernel<<<B, kThreads, smem1, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_probe * splits,
      k, kp);
  return (int)cudaGetLastError();
}

const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
