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
//           the draw is in the top-K row (log kappa summed over every hit),
//           log eps - log P otherwise
// and the padded tail pos >= S as (-1, 3e38, slot -1). The integer stream
// is the reference's splitmix32 counter hash bit for bit; the float math
// keeps the reference's order of operations, with logf / log1pf / expf
// (the build uses no fast-math).
//
// Bound. The inputs and outputs are a few hundred kilobytes (0.13 us of
// memory time at the training shape), so the work bounds it: per kappa-arm
// draw, K hashes and two logs for the Gumbel noise; per draw, K compares
// for the membership test. At eps = 0.8 four draws in five take the
// uniform arm and need no Gumbel noise at all.
//
// What the design does about that bound:
//   * 256 draws per block, a grid of (Sp / 256, B) blocks: at B = 32,
//     S = 1000 that is 128 blocks of independent work.
//   * The arm is decided first (one hash per draw). The block compacts its
//     kappa-arm draws into a shared list (warp ballot, then a prefix over
//     the 8 warps), and each warp takes one listed draw at a time: its 32
//     lanes split the K Gumbel draws and an argmax butterfly (larger value,
//     then smaller index) picks the reference's first-on-ties slot. No
//     Gumbel noise is drawn for a uniform-arm draw, and no lane idles while
//     another in its warp runs the K-long loop.
//   * The row's top-K ids and scores are read once per block into shared
//     memory, and log Z = m + log sum exp(score - m) is a block reduction
//     computed once per block, not once per draw.
//   * eps is read from device memory (a 0-d tensor), so a traced or
//     scheduled eps never costs a host round trip.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define LOG_Q_PAD_F (3.0e38f)

namespace {

constexpr int kThreads = 256;

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

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) r += red[w];
  __syncthreads();
  return r;
}

// The Gumbel-argmax of one kappa-arm draw, by one warp: lane l takes the
// slots l, l + 32, ...; the butterfly keeps the larger value and, on a tie,
// the smaller slot, which is the reference's first index on ties. Every
// lane returns the slot.
__device__ __forceinline__ int gumbel_argmax_warp(uint32_t seed, uint32_t ctr0,
                                                  const float* sc, int K, int lane) {
  const float tiny = 1e-12f;
  float best = -INFINITY;
  int slot = INT_MAX;
  for (int k = lane; k < K; k += 32) {
    const float u = uniform01(seed, ctr0 + 2u + (uint32_t)k);
    const float g = -logf(-logf(u + tiny) + tiny);
    const float v = sc[k] + g;
    if (slot == INT_MAX || v > best) {
      best = v;
      slot = k;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int os = __shfl_xor_sync(0xffffffffu, slot, o);
    if (ov > best || (ov == best && os < slot)) {
      best = ov;
      slot = os;
    }
  }
  return slot;
}

// grid (ceil(Sp / kThreads), B); dynamic shared memory K ids + K scores.
__global__ void __launch_bounds__(kThreads) fused_sampler_kernel(
    int seed_i, const float* __restrict__ eps_ptr, int row_offset,
    const int* __restrict__ topk_ids, const float* __restrict__ topk_scores,
    int* __restrict__ actions, float* __restrict__ log_q, int* __restrict__ slots,
    int S, int Sp, int K, int P) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;
  int* ids = reinterpret_cast<int*>(sc + K);
  __shared__ float red[kThreads / 32];
  __shared__ int warp_kappa[kThreads / 32];
  __shared__ int kappa_pos[kThreads];   // block-local positions of the kappa draws
  __shared__ int kappa_slot[kThreads];  // their slots, in the same order
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float local_max = -INFINITY;
  for (int e = threadIdx.x; e < K; e += kThreads) {
    const float s = topk_scores[(size_t)b * K + e];
    sc[e] = s;
    ids[e] = topk_ids[(size_t)b * K + e];
    local_max = fmaxf(local_max, s);
  }
  const float m = block_max(local_max, red);  // its barrier publishes sc / ids
  float local_sum = 0.f;
  for (int e = threadIdx.x; e < K; e += kThreads) local_sum += expf(sc[e] - m);
  const float log_z = m + logf(block_sum(local_sum, red));

  // the arm of this thread's draw, then the block's kappa draws listed
  const uint32_t seed = (uint32_t)seed_i;
  const float eps = *eps_ptr;
  const uint32_t Kc = (uint32_t)(K + 2);
  const uint32_t row_base = (uint32_t)(b + row_offset) * (uint32_t)Sp;
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t ctr0 = (row_base + (uint32_t)pos) * Kc;
  const bool live = pos < S;
  const bool take_uniform = live && uniform01(seed, ctr0) < eps;
  const bool kappa = live && !take_uniform;
  const unsigned vote = __ballot_sync(0xffffffffu, kappa);
  if (lane == 0) warp_kappa[warp] = __popc(vote);
  __syncthreads();
  int first = 0, n_kappa = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    first += w < warp ? warp_kappa[w] : 0;
    n_kappa += warp_kappa[w];
  }
  const int my_index = first + __popc(vote & ((1u << lane) - 1u));
  if (kappa) kappa_pos[my_index] = threadIdx.x;
  __syncthreads();

  // kappa arm: a warp per listed draw
  for (int i = warp; i < n_kappa; i += kThreads / 32) {
    const uint32_t c0 = (row_base + (uint32_t)(blockIdx.x * kThreads + kappa_pos[i])) * Kc;
    const int slot = gumbel_argmax_warp(seed, c0, sc, K, lane);
    if (lane == 0) kappa_slot[i] = slot;
  }
  __syncthreads();

  if (pos >= Sp) return;
  const size_t out = (size_t)b * Sp + pos;
  if (!live) {  // the padded tail: dead slots for the covgrad kernels
    actions[out] = -1;
    log_q[out] = LOG_Q_PAD_F;
    slots[out] = -1;
    return;
  }
  const int slot = kappa ? kappa_slot[my_index] : -1;
  const int action = kappa ? ids[slot] : (int)(hash_u32(seed, ctr0 + 1u) % (uint32_t)P);

  // log q at the draw: membership against the whole top-K row
  bool in_topk = false;
  float log_kappa = 0.f;
  for (int k = 0; k < K; ++k) {
    if (ids[k] == action) {
      in_topk = true;
      log_kappa += sc[k] - log_z;
    }
  }
  const float log_u = logf(eps) - logf((float)P);
  const float lq = in_topk ? logaddexp(log_u, log1pf(-eps) + log_kappa) : log_u;
  actions[out] = action;
  log_q[out] = lq;
  slots[out] = slot;
}

}  // namespace

extern "C" {

size_t fused_sampler_smem_bytes(int K) { return (size_t)K * (sizeof(float) + sizeof(int)); }

// Launches the sampler on `stream`; returns cudaGetLastError().
int fused_sampler_launch(int seed, const void* eps, int row_offset, const void* topk_ids,
                         const void* topk_scores, void* actions, void* log_q,
                         void* slots, int B, int S, int Sp, int K, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = fused_sampler_smem_bytes(K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute((const void*)fused_sampler_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sp + kThreads - 1) / kThreads, B);
  fused_sampler_kernel<<<grid, kThreads, smem, st>>>(
      seed, static_cast<const float*>(eps), row_offset,
      static_cast<const int*>(topk_ids), static_cast<const float*>(topk_scores),
      static_cast<int*>(actions), static_cast<float*>(log_q), static_cast<int*>(slots),
      S, Sp, K, P);
  return (int)cudaGetLastError();
}

const char* fused_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
