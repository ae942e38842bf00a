// Flash attention backward for Hopper (sm_90a), written by hand in CUDA
// C++ with a plain C interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/flash_attention/backward.py:flash_backward_pallas
// (its two pallas_calls: dq, and dk/dv).
//
// Computes the FlashAttention-2 backward of the forward kernel
// (flash_attention_fwd.cu) from the saved per-row logsumexp lse and
// D = rowsum(dO * O), both fp32 [B, H, Sq], for each live (query, key)
// pair of query head h and its KV head g = h / (H / KV):
//   s     = (q * scale) . k                   scale = 1 / sqrt(D), fp32
//   t     = tanh(s / cap), s = cap * t         when a cap is set
//   dcap  = 1 - t * t                          (on the uncapped s)
//   s     = live ? s : -2e38                   (the reference's NEG_INF)
//   p     = exp(s - lse)
//   dp    = dO . v
//   ds    = live ? p * (dp - D) * dcap : 0
//   dq   += ds k          (times scale at the end)
//   dk   += ds (q * scale)
//   dv   += p dO
// with live = kpos < seq_kv, and kpos <= qpos when causal, and qpos - kpos
// < window when a window is set (qpos = q_offset + row). Inputs fp32 or
// bf16 in the model's [B, S, heads, D] layout, read in place; every
// product and sum is an IEEE fp32 FMA on the inputs upcast, as the
// reference computes them; dq, dk, dv are written in the inputs' type.
//
// Bound. At the Gemma-2 training shape (B 4, H 8, KV 4, S 2048, D 256,
// causal) the function does five D-long products per live pair (s, dp,
// dv, dq, dk: 10 D flops), 172 GFLOP, and must move Q, K, V, dO, dQ, dK,
// dV, lse and D once, about 100 MB: the kernels are bound by operations
// (fp32 FMAs here), not by device memory.
//
// What the design does about it:
//   * The TPU kernels walk a sequential grid and carry dq (or dk, dv) in
//     scratch across it; GPU blocks run in no order. Here each output
//     tile has one block that loops over its inputs itself, with its fp32
//     accumulator in registers, and writes the tile once: no atomics, and
//     every sum is taken in a fixed order (the run-to-run result is bit
//     for bit the same).
//   * dq kernel: a block per (b, h, 64-row q tile) holds Q (scaled) and dO
//     in shared memory and loops over the live K/V tiles (as the forward
//     does), recomputing s, p, dp and ds; ds goes through shared memory to
//     the ds K product. The next K/V tile is loaded into registers while
//     the current one is used.
//   * dk/dv kernel: a block per (b, KV head, key tile) holds K and V in
//     shared memory and loops over the n_rep query heads of its group and,
//     for each, over the live 64-row q tiles: the GQA group sum happens in
//     the fp32 accumulators, and nothing is repeated, padded or
//     transposed. p and ds go through shared memory to the p^T dO and
//     ds^T Q products.
//   * Tiles with no live pair are not visited (above the causal diagonal,
//     behind the window, past seq_kv); a key tile with none writes zeros.
//   * 256 threads as 16 x 16. Scores: thread (ty, tx) takes q rows 4 ty ..
//     4 ty + 3 and keys tx + 16 j. dq: those four rows, D / 16 columns.
//     dk, dv: key rows BK / 16 ty .. and D / 16 columns. Tiles are fp32
//     rows padded by 4 floats in shared memory, so 16-byte reads along D
//     fall on distinct bank groups.
//   * Shared memory: dq (2 * 64 + 2 BK) (D + 4) + 64 (BK + 4) floats, dk/dv
//     64 (BK + 4) floats more; BK = 32 keys for D >= 128 (204 KB and 213
//     KB at D 256) and 64 below. Above 48 KB it is opted in, once per
//     kernel and device.

#include "flash_attention_common.cuh"

namespace {

template <int D>
struct Tiles : TileShape<D> {
  using S = TileShape<D>;
  static constexpr int RK = S::BK / 16;  // dk / dv rows per thread
  static constexpr size_t kSmemDq =
      (size_t)(2 * kBQ * S::SD + 2 * S::BK * S::SD + kBQ * S::SP) * sizeof(float);
  static constexpr size_t kSmemDkv =
      (size_t)(2 * kBQ * S::SD + 2 * S::BK * S::SD + 2 * kBQ * S::SP) * sizeof(float);
};

template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* s, const T* base, long stride, int valid,
                                          float mul) {
  TileRegs<T, D, R> r;
  r.load(base, stride, valid);
  r.store(s, mul);
}

// VEC consecutive floats of a shared row into v
template <int VEC>
__device__ __forceinline__ void read_vec(const float* src, float* v) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = src[0];
  }
}

// The thread's OC columns of a shared row: column g * 16 VEC + tx VEC + e.
template <int D>
__device__ __forceinline__ void read_cols(const float* row, int tx, float* v) {
  constexpr int OC = Tiles<D>::OC, VEC = Tiles<D>::VEC;
#pragma unroll
  for (int g = 0; g < OC / VEC; ++g) read_vec<VEC>(row + g * 16 * VEC + tx * VEC, v + g * VEC);
}

// s = Q K^T and dp = dO V^T for q rows 4 ty + i, keys tx + 16 j of the
// shared tiles (one pass over D).
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sDO, const float* sK,
                                       const float* sV, int ty, int tx,
                                       float (&s)[4][Tiles<D>::KC],
                                       float (&dp)[4][Tiles<D>::KC]) {
  constexpr int SD = Tiles<D>::SD, KC = Tiles<D>::KC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], ov[4], kv[KC], vv[KC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * SD + d);
      ov[i] = *reinterpret_cast<const float4*>(sDO + (ty * 4 + i) * SD + d);
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * SD + d);
      vv[j] = *reinterpret_cast<const float4*>(sV + (tx + 16 * j) * SD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(ov[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(ov[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// p and ds of one score in the reference's order; returns p, writes ds.
__device__ __forceinline__ float p_ds(float s, float dp, float lse, float dsum, bool live,
                                      float cap, float* ds) {
  float dcap = 1.f;
  if (cap > 0.f) {
    const float t = tanhf(s / cap);
    s = cap * t;
    dcap = 1.f - t * t;
  }
  s = live ? s : kNegInf;
  const float p = expf(s - lse);
  float d = p * (dp - dsum);
  if (cap > 0.f) d *= dcap;
  *ds = live ? d : 0.f;
  return p;
}

struct Mask {
  int Sq, seq_kv, causal, window, q_offset;
  __device__ __forceinline__ bool live(int r, int kpos) const {
    const int qpos = q_offset + r;
    return r < Sq && kpos < seq_kv && (!causal || kpos <= qpos) &&
           (window <= 0 || qpos - kpos < window);
  }
};

// grid (ceil(Sq / 64), H, B), 256 threads. q, dout, dq [B, Sq, H, D]; k, v
// [B, Skv, KV, D]; lse, dsum [B, H, Sq]. window <= 0: none; cap <= 0: none.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dq, int H, int KV, int Sq, int Skv,
    int seq_kv, int causal, int window, float cap, float scale, int q_offset) {
  using Tl = Tiles<D>;
  constexpr int BK = Tl::BK, SD = Tl::SD, SP = Tl::SP, KC = Tl::KC, OC = Tl::OC,
                VEC = Tl::VEC;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [64][SD], scaled
  float* sDO = sQ + kBQ * SD;   // [64][SD]
  float* sK = sDO + kBQ * SD;   // [BK][SD]
  float* sV = sK + BK * SD;     // [BK][SD]
  float* sDS = sV + BK * SD;    // [64][SP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const long qstride = (long)H * D;
  const long kstride = (long)KV * D;
  const long qoff = ((long)b * Sq + q0) * qstride + (long)h * D;
  const long kvoff = (long)b * Skv * kstride + (long)(h / (H / KV)) * D;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;
  const Mask mask{Sq, seq_kv, causal, window, q_offset};

  // the key tiles holding a live key for some row of this block
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + kBQ, Sq) - 1;
  const int kend = causal ? min(seq_kv, qhi + 1) : seq_kv;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int t_beg = kbeg / BK;
  const int t_end = kend > kbeg ? (kend + BK - 1) / BK : t_beg;

  const int valid_q = min(kBQ, Sq - q0);
  load_tile<T, D, kBQ>(sQ, q + qoff, qstride, valid_q, scale);
  load_tile<T, D, kBQ>(sDO, dout + qoff, qstride, valid_q, 1.f);
  float lse_r[4], dsum_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const long at = ((long)b * H + h) * Sq + r;
    lse_r[i] = r < Sq ? lse[at] : 0.f;
    dsum_r[i] = r < Sq ? dsum[at] : 0.f;
  }
  TileRegs<T, D, BK> kr, vr;
  if (t_beg < t_end) {
    const int k0 = t_beg * BK;
    kr.load(kb + k0 * kstride, kstride, min(BK, Skv - k0));
    vr.load(vb + k0 * kstride, kstride, min(BK, Skv - k0));
  }

  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  for (int t = t_beg; t < t_end; ++t) {
    __syncthreads();  // the previous tile's reads of sK, sV, sDS are done
    kr.store(sK, 1.f);
    vr.store(sV, 1.f);
    __syncthreads();
    const int k0 = t * BK;
    if (t + 1 < t_end) {  // in flight while this tile is used
      const int k1 = k0 + BK;
      kr.load(kb + k1 * kstride, kstride, min(BK, Skv - k1));
      vr.load(vb + k1 * kstride, kstride, min(BK, Skv - k1));
    }

    float s[4][KC], dp[4][KC];
    scores<D>(sQ, sDO, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int r = q0 + ty * 4 + i;
        const int kpos = k0 + tx + 16 * j;
        float ds;
        p_ds(s[i][j], dp[i][j], lse_r[i], dsum_r[i], mask.live(r, kpos), cap, &ds);
        sDS[(ty * 4 + i) * SP + tx + 16 * j] = ds;
      }
    __syncthreads();

    // acc += dS K over this tile's keys, in key order
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 dv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv4[i] = *reinterpret_cast<const float4*>(sDS + (ty * 4 + i) * SP + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kk[OC];
        read_cols<D>(sK + (c + e) * SD, tx, kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = e == 0 ? dv4[i].x : e == 1 ? dv4[i].y : e == 2 ? dv4[i].z : dv4[i].w;
#pragma unroll
          for (int cc = 0; cc < OC; ++cc) acc[i][cc] = fmaf(w, kk[cc], acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    T* row = dq + ((long)b * Sq + r) * qstride + (long)h * D;
#pragma unroll
    for (int g = 0; g < OC / VEC; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        row[g * 16 * VEC + tx * VEC + e] = to_out(acc[i][g * VEC + e] * scale, T());
  }
}

// grid (ceil(Skv / BK), KV, B), 256 threads. Layouts as the dq kernel;
// dk, dv [B, Skv, KV, D].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
    int Sq, int Skv, int seq_kv, int causal, int window, float cap, float scale,
    int q_offset) {
  using Tl = Tiles<D>;
  constexpr int BK = Tl::BK, SD = Tl::SD, SP = Tl::SP, KC = Tl::KC, OC = Tl::OC,
                VEC = Tl::VEC, RK = Tl::RK;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [64][SD], scaled
  float* sDO = sQ + kBQ * SD;   // [64][SD]
  float* sK = sDO + kBQ * SD;   // [BK][SD]
  float* sV = sK + BK * SD;     // [BK][SD]
  float* sP = sV + BK * SD;     // [64][SP]
  float* sDS = sP + kBQ * SP;   // [64][SP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;  // the first key tiles see the most rows: first
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / KV;
  const long qstride = (long)H * D;
  const long kstride = (long)KV * D;
  const long kvoff = ((long)b * Skv + k0) * kstride + (long)g * D;
  const Mask mask{Sq, seq_kv, causal, window, q_offset};

  // the q rows holding a live pair with some key of this tile
  const int khi = min(k0 + BK, seq_kv) - 1;
  int r_lo = causal ? max(0, k0 - q_offset) : 0;
  int r_hi = window > 0 ? min(Sq - 1, khi + window - 1 - q_offset) : Sq - 1;
  if (khi < k0) r_hi = -1;  // no live key in this tile
  const int qt_beg = r_lo / kBQ;
  const int qt_end = r_lo <= r_hi ? r_hi / kBQ + 1 : qt_beg;

  float adk[RK][OC], adv[RK][OC];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) adk[r][c] = adv[r][c] = 0.f;

  if (qt_beg < qt_end) {
    const int valid_k = min(BK, Skv - k0);
    load_tile<T, D, BK>(sK, k + kvoff, kstride, valid_k, 1.f);
    load_tile<T, D, BK>(sV, v + kvoff, kstride, valid_k, 1.f);
  }
  for (int hh = 0; hh < n_rep; ++hh) {
    const int h = g * n_rep + hh;
    for (int qt = qt_beg; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      const long qoff = ((long)b * Sq + q0) * qstride + (long)h * D;
      const int valid_q = min(kBQ, Sq - q0);
      __syncthreads();  // the previous tile's reads of sQ, sDO, sP, sDS are done
      load_tile<T, D, kBQ>(sQ, q + qoff, qstride, valid_q, scale);
      load_tile<T, D, kBQ>(sDO, dout + qoff, qstride, valid_q, 1.f);
      __syncthreads();

      float s[4][KC], dp[4][KC];
      scores<D>(sQ, sDO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        const long at = ((long)b * H + h) * Sq + r;
        const float l = r < Sq ? lse[at] : 0.f;
        const float dd = r < Sq ? dsum[at] : 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int kpos = k0 + tx + 16 * j;
          float ds;
          const float p = p_ds(s[i][j], dp[i][j], l, dd, mask.live(r, kpos), cap, &ds);
          sP[(ty * 4 + i) * SP + tx + 16 * j] = p;
          sDS[(ty * 4 + i) * SP + tx + 16 * j] = ds;
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q over this tile's rows, in row order
#pragma unroll 4
      for (int rr = 0; rr < kBQ; ++rr) {
        float pr[RK], dsr[RK], ov[OC], qv[OC];
        read_vec<RK>(sP + rr * SP + ty * RK, pr);
        read_vec<RK>(sDS + rr * SP + ty * RK, dsr);
        read_cols<D>(sDO + rr * SD, tx, ov);
        read_cols<D>(sQ + rr * SD, tx, qv);
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            adv[r][c] = fmaf(pr[r], ov[c], adv[r][c]);
            adk[r][c] = fmaf(dsr[r], qv[c], adk[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kr = k0 + ty * RK + r;
    if (kr >= Skv) continue;
    const long at = ((long)b * Skv + kr) * kstride + (long)g * D;
#pragma unroll
    for (int gg = 0; gg < OC / VEC; ++gg)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = gg * 16 * VEC + tx * VEC + e;
        dk[at + c] = to_out(adk[r][gg * VEC + e], T());
        dv[at + c] = to_out(adv[r][gg * VEC + e], T());
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dsum, void* dq, void* dk, void* dv, int B,
                   int H, int KV, int Sq, int Skv, int seq_kv, int causal, int window,
                   float cap, float scale, int q_offset, cudaStream_t st) {
  using Tl = Tiles<D>;
  static bool opted_dq[64] = {}, opted_dkv[64] = {};
  cudaError_t err = opt_in(flash_bwd_dq_kernel<T, D>, Tl::kSmemDq, opted_dq);
  if (err != cudaSuccess) return err;
  err = opt_in(flash_bwd_dkv_kernel<T, D>, Tl::kSmemDkv, opted_dkv);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* dsum_ = static_cast<const float*>(dsum);
  flash_bwd_dq_kernel<T, D><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, Tl::kSmemDq, st>>>(
      q_, k_, v_, do_, lse_, dsum_, static_cast<T*>(dq), H, KV, Sq, Skv, seq_kv, causal,
      window, cap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D>
      <<<dim3((Skv + Tl::BK - 1) / Tl::BK, KV, B), kThreads, Tl::kSmemDkv, st>>>(
          q_, k_, v_, do_, lse_, dsum_, static_cast<T*>(dk), static_cast<T*>(dv), H, KV,
          Sq, Skv, seq_kv, causal, window, cap, scale, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* dsum, void* dq, void* dk, void* dv, int B,
                     int H, int KV, int Sq, int Skv, int seq_kv, int causal, int window,
                     float cap, float scale, int q_offset, cudaStream_t st) {
#define FLASH_BWD_CASE(DD)                                                              \
  case DD:                                                                              \
    return launch<T, DD>(q, k, v, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv, seq_kv, \
                         causal, window, cap, scale, q_offset, st);
  switch (D) {
    FLASH_HEAD_DIMS(FLASH_BWD_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16. Launches the dq and the dk/dv kernels on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// head width without a kernel). The caller checks shapes, strides and
// alignment.
int flash_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* dsum, void* dq, void* dk, void* dv,
                     int dtype, int B, int H, int KV, int Sq, int Skv, int D, int seq_kv,
                     int causal, int window, float cap, float scale, int q_offset,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv,
                                seq_kv, causal, window, cap, scale, q_offset, st);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, dout, lse, dsum, dq, dk, dv, B, H, KV,
                                        Sq, Skv, seq_kv, causal, window, cap, scale,
                                        q_offset, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
