// In-kernel eps-mixture sampling (Algorithm 1, step 4), for Hopper
// (sm_90a), written by hand in CUDA C++ with a plain C interface (bound
// from Python with ctypes).
//
// Replaces: repro/kernels/fused_sampler/kernel.py:fused_sampler_pallas.
//
// Computes, for each batch row b and sample position pos < Sp
// (Sp = ceil(S / TS) * TS, the covgrad kernels' tile-aligned length):
//   ctr0  = ((b + row_offset) * Sp + pos) * (K + 2)   (uint32 wraparound)
//   arm   = uniform(ctr0) < eps                       (true: uniform arm)
//   slot  = argmax_k(score[k] + gumbel(ctr0 + 2 + k)) (first on ties)
//   draw  = hash(ctr0 + 1) % P on the uniform arm, ids[slot] otherwise
//   log q = logaddexp(log eps - log P, log1p(-eps) + log kappa(draw)) if
//           the draw is in the top-K row (log kappa summed over every hit,
//           in slot order), log eps - log P otherwise
// and the padded tail pos >= S as (-1, 3e38, slot -1). The integer stream
// is the reference's splitmix32 counter hash bit for bit; the float math
// keeps the reference's order of operations, with logf / log1pf / expf
// (the build uses no fast-math: a faster log would flip other near-ties).
//
// Bound. The inputs and outputs are a few hundred kilobytes (0.13 us of
// memory time at the training shape), so 32-bit instructions bound it: per
// kappa-arm draw, K slots of a hash, two accurate logs, an add and a
// compare; per draw, one hash for the arm and one for the uniform draw.
// At eps = 0.8 four draws in five take the uniform arm and need no Gumbel
// noise at all.
//
// What the design does about that bound:
//   * The kappa arm's (draw, slot) pairs are the unit of work spread over
//     the card. A block takes kTile draws (128: 256 blocks of 16 warps at
//     B 32, S 1000, two a SM), decides their arms (one hash each; a
//     ballot a warp marks the kappa-arm draws), and gives each marked draw
//     kGroup lanes (16; 32 groups, so the ~26 kappa-arm draws of a tile at
//     eps 0.8 take one round): a lane takes every kGroup-th slot, four at a
//     time, so four independent hash-and-log chains overlap; a butterfly
//     over the group (larger value, then smaller slot) picks the
//     reference's first slot on ties.
//   * Membership is a lookup, not K compares a draw: the block builds an
//     open-addressing table of the row's ids (slot + 1 a bucket, linear
//     probing, a quarter full where shared memory allows, at most half).
//     A second slot
//     of an id flags the first one's bucket; a draw whose bucket is
//     flagged sums log kappa over the row in slot order, any other reads
//     one score.
//   * The row, log Z = m + log sum exp(score - m) and the table are built
//     once per block, behind two barriers in all; the table's inserts
//     overlap the Gumbel work. The inserts' shared-memory atomics are one
//     of the larger fixed costs, so fewer, larger blocks, each building
//     one table, win.
//   * eps is read from device memory (a 0-d tensor), so a traced or
//     scheduled eps never costs a host round trip.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define LOG_Q_PAD_F (3.0e38f)

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // draws per block
constexpr int kGroup = 16;   // lanes per kappa-arm draw
constexpr int kUnroll = 4;   // slots a lane has in flight
constexpr size_t kMaxSmem = 232448;  // a Hopper block's opt-in limit
constexpr uint32_t kDup = 0x80000000u;  // a bucket's flag: its id repeats

// splitmix32 finalizer constants (the reference's _GOLDEN, _MIX1, _MIX2)
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x21F0AAADu;
constexpr uint32_t kMix2 = 0x735A2D97u;

__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t ctr) {
  uint32_t x = seed + ctr * kGolden;
  x ^= x >> 16;
  x *= kMix1;
  x ^= x >> 15;
  x *= kMix2;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t ctr) {
  return (float)(hash_u32(seed, ctr) >> 8) * (1.0f / 16777216.0f);
}

// log(exp(a) + exp(b)) in the reference's form: max + log1p(exp(-|a - b|)),
// a + b where the difference is NaN
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float amax = fmaxf(a, b);
  const float delta = a - b;
  if (isnan(delta)) return a + b;
  return amax + log1pf(expf(-fabsf(delta)));
}

// Dynamic shared memory of a block: the row and the table's buckets.
__host__ __device__ inline size_t dynamic_bytes(int K, int tab_bits) {
  return (size_t)K * (sizeof(float) + sizeof(int)) + (sizeof(uint32_t) << tab_bits);
}

constexpr size_t kStaticBytes =
    (2 * kWarps) * sizeof(float) + (kTile / 32) * sizeof(unsigned) + kTile * sizeof(int);

// The table's size, 2^bits >= 2K: four buckets a slot where that fits the
// block's shared memory, never fewer than two (a fuller table's probe
// chains grow long), so a block holds K up to 12590.
inline int table_bits(int K) {
  int bits = 1;
  while ((1ll << bits) < 4ll * K) ++bits;
  while ((1ll << (bits - 1)) >= 2ll * K && dynamic_bytes(K, bits) + kStaticBytes > kMaxSmem)
    --bits;
  return bits;
}

__device__ __forceinline__ uint32_t bucket_of(int id, int bits) {
  return ((uint32_t)id * kGolden) >> (32 - bits);
}

// The bucket that holds `id`, or -1 if the row does not hold it.
__device__ __forceinline__ int find_bucket(const uint32_t* tab, const int* ids, int id, int bits) {
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t h = bucket_of(id, bits);; h = (h + 1u) & mask) {
    const uint32_t v = tab[h];
    if (v == 0u) return -1;
    if (ids[(int)(v & ~kDup) - 1] == id) return (int)h;
  }
}

// Enters slot e under its id. A second slot of the same id flags the
// bucket of the first instead of taking one.
__device__ __forceinline__ void insert_slot(uint32_t* tab, const int* ids, int e, int bits) {
  const uint32_t mask = (1u << bits) - 1u;
  const int id = ids[e];
  for (uint32_t h = bucket_of(id, bits);; h = (h + 1u) & mask) {
    const uint32_t old = atomicCAS(tab + h, 0u, (uint32_t)e + 1u);
    if (old == 0u) return;
    if (ids[(int)(old & ~kDup) - 1] == id) {
      atomicOr(tab + h, kDup);
      return;
    }
  }
}

// The Gumbel-perturbed score of slot k, in the reference's order of
// operations.
__device__ __forceinline__ float perturbed(uint32_t seed, uint32_t ctr0, const float* sc, int k) {
  const float u = uniform01(seed, ctr0 + 2u + (uint32_t)k);
  const float g = -logf(-logf(u + 1e-12f) + 1e-12f);
  return sc[k] + g;
}

// The Gumbel-argmax of one kappa-arm draw by kGroup lanes (`gl` this
// lane's index in its group; `active` false for a group with no draw this
// round, whose result is not used). Lane gl takes the slots gl, gl + G,
// ..., in order, kUnroll at a time while a whole step of them lies below
// K; the butterfly keeps the larger value and, on a tie, the smaller slot:
// the reference's first index on ties (slot 0 where no value is larger
// than -inf, as the reference's argmax gives for a row of -inf). Every
// lane of the warp calls it (its shuffles name the whole warp).
__device__ __forceinline__ int gumbel_argmax(uint32_t seed, uint32_t ctr0, const float* sc, int K,
                                             int gl, bool active) {
  float best = -INFINITY;
  int slot = INT_MAX;
  const int k_end = active ? K : 0;
  int k0 = gl;
  for (; k0 + (kUnroll - 1) * kGroup < k_end; k0 += kUnroll * kGroup) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = perturbed(seed, ctr0, sc, k0 + u * kGroup);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v[u] > best) {
        best = v[u];
        slot = k0 + u * kGroup;
      }
    }
  }
  for (; k0 < k_end; k0 += kGroup) {
    const float v = perturbed(seed, ctr0, sc, k0);
    if (v > best) {
      best = v;
      slot = k0;
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int os = __shfl_xor_sync(0xffffffffu, slot, o);
    if (ov > best || (ov == best && os < slot)) {
      best = ov;
      slot = os;
    }
  }
  return slot == INT_MAX ? 0 : slot;
}

// The log kappa of `id` in the row, summed over every slot that holds it
// (in slot order, where its bucket is flagged); `hit` false and 0 where
// the row does not hold it.
__device__ __forceinline__ float log_kappa_of(const uint32_t* tab, const int* ids, const float* sc,
                                              int K, int id, int bits, float log_z, bool* hit) {
  const int h = find_bucket(tab, ids, id, bits);
  *hit = h >= 0;
  if (h < 0) return 0.f;
  const uint32_t v = tab[h];
  if (!(v & kDup)) return sc[(int)v - 1] - log_z;
  float l = 0.f;
  for (int k = 0; k < K; ++k)
    if (ids[k] == id) l += sc[k] - log_z;
  return l;
}

// grid (ceil(Sp / kTile), B); dynamic shared memory: K scores, K ids,
// 2^tab_bits buckets.
__global__ void __launch_bounds__(kThreads) fused_sampler_kernel(
    int seed_i, const float* __restrict__ eps_ptr, int row_offset,
    const int* __restrict__ topk_ids, const float* __restrict__ topk_scores,
    int* __restrict__ actions, float* __restrict__ log_q, int* __restrict__ slots,
    int S, int Sp, int K, int P, int tab_bits) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;
  int* ids = reinterpret_cast<int*>(sc + K);
  uint32_t* tab = reinterpret_cast<uint32_t*>(ids + K);
  __shared__ float warp_max[kWarps], warp_sum[kWarps];
  __shared__ unsigned kappa_vote[kTile / 32];  // the tile's kappa-arm draws, a bit each
  __shared__ int kappa_slot[kTile];  // their slots, in tile order
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 1. the row to shared memory, the table cleared, the tile's arms
  float m_local = -INFINITY;
  for (int e = tid; e < K; e += kThreads) {
    const float s = topk_scores[(size_t)b * K + e];
    sc[e] = s;
    ids[e] = topk_ids[(size_t)b * K + e];
    m_local = fmaxf(m_local, s);
  }
  for (int e = tid; e < (1 << tab_bits); e += kThreads) tab[e] = 0u;
  const uint32_t seed = (uint32_t)seed_i;
  const float eps = *eps_ptr;
  const uint32_t Kc = (uint32_t)(K + 2);
  const uint32_t row_base = (uint32_t)(b + row_offset) * (uint32_t)Sp;
  const int pos = blockIdx.x * kTile + tid;
  const uint32_t ctr0 = (row_base + (uint32_t)pos) * Kc;
  const bool live = tid < kTile && pos < S;
  const bool kappa = live && !(uniform01(seed, ctr0) < eps);
  const unsigned vote = __ballot_sync(0xffffffffu, kappa);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m_local = fmaxf(m_local, __shfl_xor_sync(0xffffffffu, m_local, o));
  if (lane == 0) {
    if (warp < kTile / 32) kappa_vote[warp] = vote;
    warp_max[warp] = m_local;
  }
  __syncthreads();

  // 2. log Z's sum and the table; the kappa-arm draws, kGroup lanes each
  float m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  float s_local = 0.f;
  for (int e = tid; e < K; e += kThreads) {
    s_local += expf(sc[e] - m);
    insert_slot(tab, ids, e, tab_bits);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s_local += __shfl_xor_sync(0xffffffffu, s_local, o);
  if (lane == 0) warp_sum[warp] = s_local;
  int n_kappa = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) n_kappa += __popc(kappa_vote[w]);
  constexpr int kGroups = kThreads / kGroup;
  const int grp = tid / kGroup, gl = tid % kGroup;
  for (int i0 = 0; i0 < n_kappa; i0 += kGroups) {  // block-uniform trip count
    const int i = i0 + grp;
    const bool active = i < n_kappa;
    int at = 0;  // the tile position of the i-th kappa-arm draw
    if (active) {
      int rest = i, w = 0;
      while (rest >= __popc(kappa_vote[w])) rest -= __popc(kappa_vote[w++]);
      unsigned bits = kappa_vote[w];
      for (; rest > 0; --rest) bits &= bits - 1u;
      at = 32 * w + __ffs(bits) - 1;
    }
    const uint32_t c0 = (row_base + (uint32_t)(blockIdx.x * kTile + at)) * Kc;
    const int slot = gumbel_argmax(seed, c0, sc, K, gl, active);
    if (active && gl == 0) kappa_slot[i] = slot;
  }
  __syncthreads();

  // 3. each draw: its action, log q at it, its slot
  if (tid >= kTile || pos >= Sp) return;
  const size_t out = (size_t)b * Sp + pos;
  if (!live) {  // the padded tail: dead slots for the covgrad kernels
    actions[out] = -1;
    log_q[out] = LOG_Q_PAD_F;
    slots[out] = -1;
    return;
  }
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
  const float log_z = m + logf(total);
  int slot = -1, action;
  if (kappa) {
    int index = __popc(vote & ((1u << lane) - 1u));  // the draw's rank in the tile
    for (int w = 0; w < warp; ++w) index += __popc(kappa_vote[w]);
    slot = kappa_slot[index];
    action = ids[slot];
  } else {
    action = (int)(hash_u32(seed, ctr0 + 1u) % (uint32_t)P);
  }
  bool hit;
  const float lk = log_kappa_of(tab, ids, sc, K, action, tab_bits, log_z, &hit);
  const float log_u = logf(eps) - logf((float)P);
  actions[out] = action;
  log_q[out] = hit ? logaddexp(log_u, log1pf(-eps) + lk) : log_u;
  slots[out] = slot;
}

}  // namespace

extern "C" {

// Shared memory one block needs at this K, static arrays included.
size_t fused_sampler_smem_bytes(int K) { return dynamic_bytes(K, table_bits(K)) + kStaticBytes; }

// Launches the sampler on `stream`; returns cudaGetLastError().
int fused_sampler_launch(int seed, const void* eps, int row_offset, const void* topk_ids,
                         const void* topk_scores, void* actions, void* log_q,
                         void* slots, int B, int S, int Sp, int K, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bits = table_bits(K);
  const size_t smem = dynamic_bytes(K, bits);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)fused_sampler_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sp + kTile - 1) / kTile, B);
  fused_sampler_kernel<<<grid, kThreads, smem, st>>>(
      seed, static_cast<const float*>(eps), row_offset,
      static_cast<const int*>(topk_ids), static_cast<const float*>(topk_scores),
      static_cast<int*>(actions), static_cast<float*>(log_q), static_cast<int*>(slots),
      S, Sp, K, P, bits);
  return (int)cudaGetLastError();
}

const char* fused_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
