// Device helpers shared by the two retrieval top-K kernels, the exact
// streamed MIPS (mips_topk/csrc/mips_topk.cu) and the IVF probe
// (ivf_topk/csrc/ivf_topk.cu): the order of candidates, a warp's bitonic
// sort in registers, the radix-select fold of a running top-K, the
// `cp.async` copies and the shared-memory opt-in. The build hashes this
// directory's headers with every source, so an edit here rebuilds both.
//
// A running top-K lives in shared memory as `kp` top slots followed by an
// append buffer, with a count of appended entries and a threshold: the
// K-th score at the last fold. A candidate joins the buffer only if it
// beats the threshold (a tie loses: the earlier candidate keeps its
// place). When the buffer could overflow, one warp folds it: a radix
// select over the scores' order keys finds the new K-th score, the
// entries above it move to the top slots in any order, and the threshold
// rises. Nothing is sorted until the end, where one warp sorts the top
// slots once in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-3.0e38f)  // the reference's NEG_INF: a dead slot's score

namespace {

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// cp.async: copies from device to shared memory that the issuing thread
// does not wait for, committed in groups
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// order and sort
// ---------------------------------------------------------------------------

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

// Sort the warp's R * 32 pairs (R a power of two) into descending order.
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

// ---------------------------------------------------------------------------
// the running top-K
// ---------------------------------------------------------------------------

// `used` slots loaded into one warp's registers, element e = r * 32 +
// lane; the registers past them read as dead (NEG_INF, -1).
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

// Fold a query's buffer into its top-K without sorting (one warp; R * 32
// >= kp + *count): find the K-th largest score by a radix select over the
// scores' order keys, two bits a round from the top (three compares per
// key and three warp sums, taken together), until exactly K keys are above
// the prefix (about half the 16 rounds); move the K entries above it (and
// enough of those equal to it, earlier slots first) to slots [0, k) in any
// order, clear [k, kp), and raise the threshold to that K-th score. The
// warp holds keys and ids only: a key gives its score back bit for bit.
template <int R>
__device__ void select_query(float* s, int* id, int* count, float* theta, int k, int kp,
                             int lane) {
  const int used = kp + *count;
  unsigned key[R];
  int ri[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const bool live = e < used;
    key[r] = order_key(live ? s[e] : NEG_INF_F);
    ri[r] = live ? id[e] : -1;
  }
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
    const int t1 = __reduce_add_sync(0xffffffffu, n1);
    const int t2 = __reduce_add_sync(0xffffffffu, n2);
    const int t3 = __reduce_add_sync(0xffffffffu, n3);
    const unsigned cand = t3 >= k ? c3 : t2 >= k ? c2 : c1;
    const int total = t3 >= k ? t3 : t2 >= k ? t2 : t1;
    if (total < k) continue;  // the K-th key has 00 here
    kth = cand;
    if (total == k) {  // exactly the k best are >= cand: the K-th is their least
      unsigned least = 0xffffffffu;
#pragma unroll
      for (int r = 0; r < R; ++r) least = key[r] >= cand ? min(least, key[r]) : least;
      kth = __reduce_min_sync(0xffffffffu, least);
      break;
    }
  }
  int above = 0, equal = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    above += key[r] > kth;
    equal += key[r] == kth;
  }
  const int ties = k - __reduce_add_sync(0xffffffffu, above);
  const bool all_ties = __reduce_add_sync(0xffffffffu, equal) == ties;  // no tie to break
  const unsigned before_lane = (1u << lane) - 1u;
  int written = 0, ties_seen = 0;
  __syncwarp();  // every lane has read its slots before any is rewritten
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool keep = key[r] >= kth;
    if (!all_ties) {
      const unsigned eq = __ballot_sync(0xffffffffu, key[r] == kth);
      keep = key[r] > kth || (key[r] == kth && ties_seen + __popc(eq & before_lane) < ties);
      ties_seen += __popc(eq);
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = written + __popc(kept & before_lane);
      s[pos] = key_value(key[r]);
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

// Slots [0, used) of a top-K (RT * 32 >= used) sorted in the warp's
// registers: element e = r * 32 + lane of `s` / `id` is the e-th best.
template <int RT>
__device__ __forceinline__ void sorted_top(const float* s, const int* id, int used, int lane,
                                           float (&rs)[RT], int (&ri)[RT]) {
  load_slots<RT>(s, id, used, lane, rs, ri);
  warp_sort_regs<RT>(rs, ri, lane);
}

// A running top-K of kp = RT * 32 top slots and CAP append slots: one
// warp folds it when it holds at least `at_least` appended entries.
template <int RT, int CAP>
__device__ __forceinline__ void fold_if(float* ts, int* ti, int* cnt, float* theta, int k,
                                        int at_least, int lane) {
  if (*cnt >= at_least) select_query<RT + CAP / 32>(ts, ti, cnt, theta, k, RT * 32, lane);
}

// The first k of a warp's sorted registers to out_s / out_i.
template <int R>
__device__ __forceinline__ void write_first(const float (&rs)[R], const int (&ri)[R], int k,
                                            int lane, float* out_s, int* out_i) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < k) {
      out_s[e] = rs[r];
      out_i[e] = ri[r];
    }
  }
}

// One warp: the K best of a running top-K, sorted, to out_s / out_i [k]:
// the last fold and one sort of the top slots; or, for a top-K of at
// most 64 slots whose buffer holds no more than that, one sort of the top
// slots and the buffer together (cheaper than a fold).
template <int RT, int CAP>
__device__ void write_top(float* ts, int* ti, int* cnt, float* theta, int k, int lane,
                          float* out_s, int* out_i) {
  if constexpr (RT <= 2) {
    if (*cnt <= RT * 32) {
      float rs[2 * RT];
      int ri[2 * RT];
      sorted_top<2 * RT>(ts, ti, RT * 32 + *cnt, lane, rs, ri);
      write_first<2 * RT>(rs, ri, k, lane, out_s, out_i);
      return;
    }
  }
  fold_if<RT, CAP>(ts, ti, cnt, theta, k, 1, lane);
  float rs[RT];
  int ri[RT];
  sorted_top<RT>(ts, ti, RT * 32, lane, rs, ri);
  write_first<RT>(rs, ri, k, lane, out_s, out_i);
}

// The top-K of `lists` sorted lists of k entries (list g at ps + g * k and
// pi + g * k, written by other blocks: read through L2) to out_s / out_i,
// by every thread of the block. The lists are staged in ms / mi, `room`
// (score, id) pairs, up to 32 ranks of every list at once, rank-major
// (one round trip for the usual few ranks). Warp 0 reads them rank by
// rank into the running top-K ts / ti (RT * 32 + CAP slots, reset here),
// appends what beats the threshold, folds when the buffer holds K entries
// or could overflow, and stops after the first rank none of whose entries
// beats the threshold: the lists are sorted, so no later entry can.
// `stop` is a shared flag.
template <int RT, int CAP>
__device__ void merge_lists(const float* ps, const int* pi, int lists, int k, float* ms, int* mi,
                            int room, float* ts, int* ti, int* cnt, float* theta, int* stop,
                            float* out_s, int* out_i) {
  constexpr int kp = RT * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < kp + CAP; e += blockDim.x) {
    ts[e] = NEG_INF_F;
    ti[e] = -1;
  }
  if (threadIdx.x == 0) {
    *cnt = 0;
    *theta = NEG_INF_F;
    *stop = 0;
  }
  const int u_max = max(1, min(min(k, 32), room / lists));
  const unsigned below = (1u << lane) - 1u;
  for (int r0 = 0; r0 < k; r0 += u_max) {
    const int u = min(u_max, k - r0);
    __syncthreads();  // the last piece is read (and the state reset)
    for (int e = threadIdx.x; e < lists * u; e += blockDim.x) {
      const int g = e / u, rr = e - g * u;
      ms[rr * lists + g] = __ldcg(ps + (size_t)g * k + r0 + rr);
      mi[rr * lists + g] = __ldcg(pi + (size_t)g * k + r0 + rr);
    }
    __syncthreads();
    if (warp == 0) {
      for (int rr = 0; rr < u; ++rr) {
        bool any = false;
        for (int g0 = 0; g0 < lists; g0 += 32) {
          const int g = g0 + lane;
          const float sc = g < lists ? ms[rr * lists + g] : NEG_INF_F;
          const int cid = g < lists ? mi[rr * lists + g] : -1;
          const bool wins = cid >= 0 && sc > *theta;
          const unsigned mask = __ballot_sync(0xffffffffu, wins);
          if (mask == 0) continue;
          any = true;
          fold_if<RT, CAP>(ts, ti, cnt, theta, k, CAP - __popc(mask) + 1, lane);
          if (wins) {
            const int pos = kp + *cnt + __popc(mask & below);
            ts[pos] = sc;
            ti[pos] = cid;
          }
          __syncwarp();
          if (lane == 0) *cnt += __popc(mask);
          __syncwarp();
        }
        if (!any) {
          if (lane == 0) *stop = 1;
          break;
        }
        // a fresh threshold once the buffer holds K entries (or a warp's round)
        fold_if<RT, CAP>(ts, ti, cnt, theta, k, max(k, 32), lane);
      }
    }
    __syncthreads();
    if (*stop) break;
  }
  if (warp == 0) write_top<RT, CAP>(ts, ti, cnt, theta, k, lane, out_s, out_i);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit on the current device when
// a launch needs more than it was last set to (the call costs host time,
// so it is made once per new maximum, not once per launch). `which`
// numbers the source's kernels, below kMaxKernels.
constexpr int kMaxKernels = 16;

inline cudaError_t ensure_smem(int which, const void* fn, size_t bytes) {
  static size_t set_to[kMaxKernels][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (which < 0 || which >= kMaxKernels || dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  if (bytes <= set_to[which][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set_to[which][dev] = bytes;
  return err;
}

}  // namespace
