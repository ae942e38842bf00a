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
//     matrix exists. Each probed tile of T list slots (T*L contiguous
//     floats) is copied once into shared memory and scored there.
//   * The copies are asynchronous (cp.async) and double-buffered: a block
//     issues every load of the next tile before it scores the current one,
//     so many loads are in flight per SM instead of one per thread.
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
//   * L = 50 (SASRec) makes a row 200 bytes, not 16-byte aligned, so the
//     copies are 4 bytes each. Padding L for 16-byte copies is left for
//     later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-3.0e38f)

namespace {

constexpr int kThreads = 128;  // threads per block == candidates per tile

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
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

// Issue the cp.async copies of one tile (m slots from t0) and commit them
// as one group.
__device__ void issue_tile(float* tile, int* tile_ids, const float* embs_c,
                           const int* ids_c, int t0, int m, int L) {
  const float* src = embs_c + (size_t)t0 * L;
  for (int e = threadIdx.x; e < m * L; e += blockDim.x) cp_async4(tile + e, src + e);
  if (threadIdx.x < m) cp_async4(tile_ids + threadIdx.x, ids_c + t0 + threadIdx.x);
  cp_async_commit();
}

// grid (n_probe * splits, B). Block (j, b) scores list slots
// [split * chunk, min(capp, (split + 1) * chunk)) of cluster probe[b, j / splits]
// and writes that range's top-K to part_s / part_i [B, n_probe * splits, K].
__global__ void ivf_probe_kernel(
    const float* __restrict__ q, const int* __restrict__ probe,
    const int* __restrict__ lists, const float* __restrict__ embs,
    float* __restrict__ part_s, int* __restrict__ part_i,
    int L, int n_probe, int capp, int k, int kp, int splits, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                                               // [2][T*L]
  int* tile_ids = reinterpret_cast<int*>(tiles + 2 * kThreads * L);  // [2][T]
  float* qs = reinterpret_cast<float*>(tile_ids + 2 * kThreads);     // [L]
  float* ts = qs + L;                                         // top-K scores
  int* ti = reinterpret_cast<int*>(ts + topk_buffer(kp));     // top-K ids
  __shared__ int count, live_end;
  const TopK top{ts, ti, &count, k, kp};

  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int c = probe[b * n_probe + j / splits];
  const int lo = (j % splits) * chunk;
  const int hi = min(capp, lo + chunk);
  const float* embs_c = embs + (size_t)c * capp * L;
  const int* ids_c = lists + (size_t)c * capp;

  for (int e = threadIdx.x; e < L; e += blockDim.x) qs[e] = q[(size_t)b * L + e];
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

  const int ntiles = (end - lo + kThreads - 1) / kThreads;
  if (ntiles > 0) issue_tile(tiles, tile_ids, embs_c, ids_c, lo, min(kThreads, end - lo), L);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const int t0 = lo + t * kThreads;
    const int m = min(kThreads, end - t0);
    if (t + 1 < ntiles) {
      const int n0 = t0 + kThreads;
      issue_tile(tiles + (buf ^ 1) * kThreads * L, tile_ids + (buf ^ 1) * kThreads,
                 embs_c, ids_c, n0, min(kThreads, end - n0), L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cid = threadIdx.x < m ? tile_ids[buf * kThreads + threadIdx.x] : -1;
    float sc = NEG_INF_F;
    if (cid >= 0) {
      const float* row = tiles + buf * kThreads * L + threadIdx.x * L;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc = fmaf(qs[l], row[l], acc);
      sc = acc;
    }
    offer(top, sc, cid);
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
  static size_t set_to[2][64] = {};
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

// Dynamic shared memory of the probe (which = 0) and merge (1) kernels,
// in bytes; the caller checks it against the card's limit.
size_t ivf_topk_smem_bytes(int L, int k, int which) {
  const size_t topk = (size_t)topk_buffer(next_pow2(k)) * (sizeof(float) + sizeof(int));
  if (which == 0)
    return topk + (size_t)(2 * kThreads * L + L) * sizeof(float) +
           2 * kThreads * sizeof(int);
  return topk;
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
  const size_t smem0 = ivf_topk_smem_bytes(L, k, 0);
  const size_t smem1 = ivf_topk_smem_bytes(L, k, 1);
  cudaError_t err = ensure_smem(0, (const void*)ivf_probe_kernel, smem0);
  if (err != cudaSuccess) return (int)err;
  err = ensure_smem(1, (const void*)ivf_merge_kernel, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid0(n_probe * splits, B);
  ivf_probe_kernel<<<grid0, kThreads, smem0, st>>>(
      static_cast<const float*>(q), static_cast<const int*>(probe),
      static_cast<const int*>(lists), static_cast<const float*>(embs),
      static_cast<float*>(part_s), static_cast<int*>(part_i), L, n_probe,
      capp, k, kp, splits, chunk);
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
