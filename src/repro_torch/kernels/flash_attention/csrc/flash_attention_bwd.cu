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
//   s     = scale * (q . k)                    scale = 1 / sqrt(D), fp32
//   t     = tanh(s / cap), s = cap * t         when a cap is set
//   dcap  = 1 - t * t                          (on the uncapped s)
//   s     = live ? s : -2e38                   (the reference's NEG_INF)
//   p     = exp(s - lse)
//   dp    = dO . v
//   ds    = live ? p * (dp - D) * dcap : 0
//   dq    = scale * sum ds k                   (scaled once, at the end)
//   dk    = scale * sum ds q
//   dv    = sum p dO
// with live = kpos < seq_kv, and kpos <= qpos when causal, and qpos - kpos
// < window when a window is set (qpos = q_offset + row). Inputs fp32 or
// bf16 in the model's [B, S, heads, D] layout, read in place; dq, dk, dv
// written in the inputs' type. All five products run on the tensor cores
// with fp32 accumulation (flash_attention_common.cuh): s and dp exactly
// in bf16 for bf16 inputs, the p and ds products with p and ds split into
// two bf16 terms; for fp32 inputs all five as 3xTF32. Each tile's product
// is summed in a fresh accumulator and added to the output's with an
// IEEE fp32 add (the tensor cores' own accumulation cuts). The reference
// scales q before its products; here the scale multiplies the fp32 sums
// of s, dq and dk (one rounding apart; the same for D 16, 64 and 256).
//
// Bound. At the Gemma-2 training shape (B 4, H 8, KV 4, S 2048, D 256,
// causal) the function does five D-long products per live pair (s, dp,
// dv, dq, dk: 10 D flops), 172 GFLOP, and must move Q, K, V, dO, dQ, dK,
// dV, lse and D once, about 100 MB: bound by the tensor cores' operations
// (in bf16 two products once and three twice for the split, at 989
// TFLOP/s; in fp32 three tf32 products each at 495).
//
// What the design does about it:
//   * The TPU kernels walk a sequential grid and carry dq (or dk, dv) in
//     scratch across it; GPU blocks run in no order. Here each output
//     tile has one block that loops over its inputs itself, with its fp32
//     accumulators in registers (mma fragments), and writes the tile
//     once: no atomics, and every sum is taken in a fixed order (the
//     run-to-run result is bit for bit the same).
//   * dq kernel: a block per (b, h, 64-row q tile), four warps of 16 rows,
//     holds Q and dO in shared memory and loops over the live K/V tiles
//     (as the forward does), recomputing s, p, dp and ds on the warp's
//     accumulator fragments; ds goes from them straight into the A
//     operand of the ds K product. At D 256, where one block fills an
//     SM's shared memory, a second group of four warps takes the other
//     half of each tile's keys; the two dq sums are added at the end, in
//     that order.
//   * dk/dv kernel: a block per (b, KV head, key tile of BKV keys), eight
//     warps, holds K and V in shared memory and loops over the n_rep query
//     heads of its group and, for each, over the live 64-row q tiles: the
//     GQA group sum happens in the fp32 accumulators, and nothing is
//     repeated, padded or transposed. It computes s^T = k q^T and dp^T =
//     v dO^T (keys as rows), so p^T and ds^T come out in the layout of the
//     A operand of dv += p^T dO and dk += ds^T q; they pass through shared
//     memory (split) because the second pair of products divides the warps
//     over D columns: a warp owns 16 keys and D / WN columns of both dk and
//     dv (WN = 4 from D 64; 32 keys a block there), which keeps its
//     accumulators at 64 registers at D 256 and the main path's B 1,
//     S 2048 at 256 key tiles, enough to fill the card. Its q tiles are 64
//     rows (32 for fp32 at D 256).
//   * Tiles stay in the inputs' type in shared memory, loaded by 16-byte
//     `cp.async`, the streamed tiles (K/V in dq, Q/dO in dk/dv) in a ring
//     of two stages (fp32 at D 256 takes 16-key tiles in dq and 32-row q
//     tiles in dk/dv to fit them). Above 48 KB shared memory is opted in,
//     once per kernel and device.
//   * Tiles with no live pair are not visited (above the causal diagonal,
//     behind the window, past seq_kv); a key tile with none writes zeros.
//     The longest blocks start first.

#include "flash_attention_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile

// p and ds of one score (already scaled) in the reference's order; returns
// p, writes ds.
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

// ---------------------------------------------------------------------------
// dq: grid (ceil(Sq / 64), H, B), 128 threads (256 with KSPLIT 2)
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqTiles {
  using M = typename MmaOf<T>::type;
  // keys per tile: fp32 at D 256 takes 16, so two stages fit beside Q, dO
  static constexpr int BK =
      sizeof(T) == 4 && D == 256 ? 16 : (D == 256 || (sizeof(T) == 4 && D >= 128)) ? 32 : 64;
  static constexpr int LD = D + M::EPC;
  static constexpr int STAGES =
      (size_t)(2 * kBQ + 4 * BK) * LD * sizeof(T) <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = (size_t)(2 * kBQ + 2 * STAGES * BK) * LD * sizeof(T);
  // Where one block fills an SM's shared memory (D 256), two groups of
  // four warps split each tile's keys, their dq sums added at the end
  static constexpr int KSPLIT = kSmem > kMaxSmem / 2 ? 2 : 1;
  static constexpr int kThreads = 128 * KSPLIT;
  static constexpr int BKG = BK / KSPLIT;  // a warp group's keys of each tile
  static_assert(kSmem <= kMaxSmem, "shared memory");
  static_assert(KSPLIT == 1 || (size_t)kBQ * D * 4 <= (size_t)2 * STAGES * BK * LD * sizeof(T),
                "the groups' sum fits the K/V stages");
};

// q, dout, dq [B, Sq, H, D]; k, v [B, Skv, KV, D]; lse, dsum [B, H, Sq].
template <typename T, int D>
__global__ void __launch_bounds__(DqTiles<T, D>::kThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dq, int H, int KV, int Sq, int Skv,
    int seq_kv, int causal, int window, float cap, float scale, int q_offset) {
  using Tl = DqTiles<T, D>;
  using M = typename Tl::M;
  constexpr int BK = Tl::BK, BKG = Tl::BKG, LD = Tl::LD, STAGES = Tl::STAGES, NT = BKG / 8,
                DT = D / 8, kDqThreads = Tl::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* sDO = sQ + kBQ * LD;                  // [64][LD]
  T* sKV = sDO + kBQ * LD;                 // STAGES x ([BK][LD] K, [BK][LD] V)

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int warp = (threadIdx.x >> 5) & 3;  // row warp: rows warp * 16 ..
  const int grp = threadIdx.x >> 7;         // warp group: keys grp * BKG .. of each tile
  const int ko = grp * BKG;
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

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    T* sK = sKV + stage * 2 * BK * LD;
    load_tile<T, BK, D, LD, kDqThreads>(sK, kb + k0 * kstride, kstride, min(BK, Skv - k0));
    load_tile<T, BK, D, LD, kDqThreads>(sK + BK * LD, vb + k0 * kstride, kstride,
                                        min(BK, Skv - k0));
  };
  const int valid_q = min(kBQ, Sq - q0);
  load_tile<T, kBQ, D, LD, kDqThreads>(sQ, q + qoff, qstride, valid_q);
  load_tile<T, kBQ, D, LD, kDqThreads>(sDO, dout + qoff, qstride, valid_q);
  if (STAGES == 2 && t_beg < t_end) load_kv(t_beg, 0);
  cp_async_commit();

  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    const long at = ((long)b * H + h) * Sq + r;
    lse_r[i] = r < Sq ? lse[at] : 0.f;
    dsum_r[i] = r < Sq ? dsum[at] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = t_beg; t < t_end; ++t) {
    const int stage = STAGES == 2 ? (t - t_beg) & 1 : 0;
    if (STAGES == 2) {
      if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);  // in flight while this tile is used
    } else {
      load_kv(t, 0);
    }
    cp_async_commit();
    if (STAGES == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const T* sK = sKV + stage * 2 * BK * LD;
    const T* sV = sK + BK * LD;

    // s = q k^T and dp = dO v^T for the warp's 16 rows (ss, dps: the small
    // terms of 3xTF32)
    float s[NT][4], ss[NT][4], dp[NT][4], dps[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ss[n][e] = dp[n][e] = dps[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::KS) {
      typename M::A aq, ao;
      M::load_a(aq, sQ, LD, warp * 16, kk);
      M::load_a(ao, sDO, LD, warp * 16, kk);
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, sK, LD, ko + n * 8, kk);
        M::mma(s[n], ss[n], aq, b0);
        M::mma(s[n + 1], ss[n + 1], aq, b1);
        M::load_b_nk(b0, b1, sV, LD, ko + n * 8, kk);
        M::mma(dp[n], dps[n], ao, b0);
        M::mma(dp[n + 1], dps[n + 1], ao, b1);
      }
      if constexpr (NT % 2) {
        typename M::B b0;
        M::load_b_nk1(b0, sK, LD, ko + (NT - 1) * 8, kk);
        M::mma(s[NT - 1], ss[NT - 1], aq, b0);
        M::load_b_nk1(b0, sV, LD, ko + (NT - 1) * 8, kk);
        M::mma(dp[NT - 1], dps[NT - 1], ao, b0);
      }
    }
    // ds, in place of s
    const int k0 = t * BK;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = q0 + warp * 16 + g + 8 * i;
        const int kpos = k0 + ko + n * 8 + 2 * tq + (e & 1);
        float ds;
        const float sv = M::kSplitInputs ? s[n][e] + ss[n][e] : s[n][e];
        const float dpv = M::kSplitInputs ? dp[n][e] + dps[n][e] : dp[n][e];
        p_ds(sv * scale, dpv, lse_r[i], dsum_r[i], mask.live(r, kpos), cap, &ds);
        s[n][e] = ds;
      }
    // acc += ds k over this tile's keys: ds split, the tile's product in
    // fresh accumulators, then added to acc
    typename M::template SA<2> da[BKG / M::KS];
#pragma unroll
    for (int kk = 0; kk < BKG / M::KS; ++kk) M::template from_acc<2>(da[kk], s, kk);
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      float tm[2][4] = {}, ts[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < BKG / M::KS; ++kk) {
        typename M::B b0, b1;
        M::template load_b_kn<true>(b0, b1, sK, LD, ko + kk * M::KS, n * 8);
        M::mma(tm[0], ts[0], da[kk], b0);
        M::mma(tm[1], ts[1], da[kk], b1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n + j][e] += tm[j][e] + ts[j][e];
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block

  if constexpr (Tl::KSPLIT == 2) {
    // group 1's dq sum into group 0's, through the free K/V stages
    float* xa = reinterpret_cast<float*>(sKV);  // [64][D]
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < DT; ++n)
          store2(xa + (warp * 16 + g + 8 * i) * D + n * 8 + 2 * tq, acc[n][2 * i],
                 acc[n][2 * i + 1]);
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const float2 x =
            *reinterpret_cast<const float2*>(xa + (warp * 16 + g + 8 * i) * D + n * 8 + 2 * tq);
        acc[n][2 * i] += x.x;
        acc[n][2 * i + 1] += x.y;
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= Sq) continue;
    T* row = dq + ((long)b * Sq + r) * qstride + (long)h * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(row + n * 8 + 2 * tq, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(Skv / BKV), KV, B), 256 threads
// ---------------------------------------------------------------------------

constexpr int kDkvWarps = 8;
constexpr int kDkvThreads = 32 * kDkvWarps;

template <typename T, int D>
struct DkvTiles {
  using M = typename MmaOf<T>::type;
  // q rows per tile: fp32 at D 256 takes 32, so two stages of Q, dO fit
  static constexpr int BQ = sizeof(T) == 4 && D == 256 ? 32 : 64;
  static constexpr int WN = D >= 64 ? 4 : D / 16;  // warps across D (and across q)
  static constexpr int WK = kDkvWarps / WN;        // warps across keys, 16 keys each
  static constexpr int BKV = 16 * WK;              // keys per block
  static constexpr int QW = BQ / WN;               // q columns of a warp's s^T
  static constexpr int DW = D / WN;                // d columns of a warp's dk, dv
  static constexpr int LD = D + M::EPC;
  static constexpr int LDP = BQ + M::EPC;  // row stride of the p^T, ds^T planes
  static constexpr int PLANE = BKV * LDP;
  static constexpr size_t kFixed =  // K, V, then p^T's and ds^T's planes
      (size_t)(2 * BKV * LD + 2 * M::kPlanes * PLANE) * sizeof(T);
  static constexpr size_t kStage =  // Q, dO, then lse, D
      (size_t)2 * BQ * LD * sizeof(T) + 2 * BQ * sizeof(float);
  static constexpr int STAGES = kFixed + 2 * kStage <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = kFixed + STAGES * kStage;
  static_assert(kSmem <= kMaxSmem, "shared memory");
  static_assert(QW % 8 == 0 && DW % 16 == 0, "whole n-tiles; pairs across D");
};

// Layouts as the dq kernel; dk, dv [B, Skv, KV, D].
template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads, 1) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
    int Sq, int Skv, int seq_kv, int causal, int window, float cap, float scale,
    int q_offset) {
  using Tl = DkvTiles<T, D>;
  using M = typename Tl::M;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, WN = Tl::WN, QW = Tl::QW, DW = Tl::DW,
                LD = Tl::LD, LDP = Tl::LDP, PLANE = Tl::PLANE, STAGES = Tl::STAGES;
  constexpr int NQ = QW / 8, DN = DW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BKV][LD]
  T* sV = sK + BKV * LD;                   // [BKV][LD]
  T* sP = sV + BKV * LD;                   // p^T, kPlanes x [BKV][LDP]
  T* sDS = sP + M::kPlanes * PLANE;        // ds^T, the same
  unsigned char* stage0 = smem_raw + Tl::kFixed;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wk = warp / WN, wn = warp % WN;
  const int k0 = blockIdx.x * BKV;  // the first key tiles see the most rows: first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / KV;
  const long qstride = (long)H * D;
  const long kstride = (long)KV * D;
  const long kvoff = ((long)b * Skv + k0) * kstride + (long)kvh * D;
  const Mask mask{Sq, seq_kv, causal, window, q_offset};

  // the q rows holding a live pair with some key of this tile
  const int khi = min(k0 + BKV, seq_kv) - 1;
  const int r_lo = causal ? max(0, k0 - q_offset) : 0;
  int r_hi = window > 0 ? min(Sq - 1, khi + window - 1 - q_offset) : Sq - 1;
  if (khi < k0) r_hi = -1;  // no live key in this tile
  const int qt_beg = r_lo / BQ;
  const int nqt = r_lo <= r_hi ? r_hi / BQ + 1 - qt_beg : 0;
  const int items = n_rep * nqt;  // (head, q tile) pairs, head-major

  auto stage_ptr = [&](int st) { return stage0 + st * Tl::kStage; };
  auto load_q = [&](int item, int st) {
    const int h = kvh * n_rep + item / nqt;
    const int q0 = (qt_beg + item % nqt) * BQ;
    T* sQ = reinterpret_cast<T*>(stage_ptr(st));
    T* sDO = sQ + BQ * LD;
    float* sL = reinterpret_cast<float*>(sDO + BQ * LD);
    const long qoff = ((long)b * Sq + q0) * qstride + (long)h * D;
    const int valid = min(BQ, Sq - q0);
    load_tile<T, BQ, D, LD, kDkvThreads>(sQ, q + qoff, qstride, valid);
    load_tile<T, BQ, D, LD, kDkvThreads>(sDO, dout + qoff, qstride, valid);
    const long at = ((long)b * H + h) * Sq + q0;
    for (int c = threadIdx.x; c < 2 * BQ; c += kDkvThreads) {
      const int r = c % BQ;
      const float* src = (c < BQ ? lse : dsum) + at + r;
      cp_async4(sL + c, r < valid ? src : lse, r < valid);
    }
  };

  if (nqt > 0) {
    const int valid_k = min(BKV, Skv - k0);
    load_tile<T, BKV, D, LD, kDkvThreads>(sK, k + kvoff, kstride, valid_k);
    load_tile<T, BKV, D, LD, kDkvThreads>(sV, v + kvoff, kstride, valid_k);
    if (STAGES == 2) load_q(0, 0);
  }
  cp_async_commit();

  float adk[DN][4], adv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int item = 0; item < items; ++item) {
    const int st = STAGES == 2 ? item & 1 : 0;
    if (STAGES == 2) {
      if (item + 1 < items) load_q(item + 1, st ^ 1);
    } else {
      load_q(item, 0);
    }
    cp_async_commit();
    if (STAGES == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const T* sQ = reinterpret_cast<const T*>(stage_ptr(st));
    const T* sDO = sQ + BQ * LD;
    const float* sLse = reinterpret_cast<const float*>(sDO + BQ * LD);
    const float* sDsum = sLse + BQ;
    const int q0 = (qt_beg + item % nqt) * BQ;

    // s^T = k q^T and dp^T = v dO^T: the warp's 16 keys x QW q columns
    float s[NQ][4], ss[NQ][4], dp[NQ][4], dps[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ss[n][e] = dp[n][e] = dps[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::KS) {
      typename M::A ak, av;
      M::load_a(ak, sK, LD, wk * 16, kk);
      M::load_a(av, sV, LD, wk * 16, kk);
#pragma unroll
      for (int n = 0; n + 1 < NQ; n += 2) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, sQ, LD, wn * QW + n * 8, kk);
        M::mma(s[n], ss[n], ak, b0);
        M::mma(s[n + 1], ss[n + 1], ak, b1);
        M::load_b_nk(b0, b1, sDO, LD, wn * QW + n * 8, kk);
        M::mma(dp[n], dps[n], av, b0);
        M::mma(dp[n + 1], dps[n + 1], av, b1);
      }
      if constexpr (NQ % 2) {
        typename M::B b0;
        M::load_b_nk1(b0, sQ, LD, wn * QW + (NQ - 1) * 8, kk);
        M::mma(s[NQ - 1], ss[NQ - 1], ak, b0);
        M::load_b_nk1(b0, sDO, LD, wn * QW + (NQ - 1) * 8, kk);
        M::mma(dp[NQ - 1], dps[NQ - 1], av, b0);
      }
    }
    // p^T and ds^T into shared memory
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int krow = wk * 16 + g + 8 * i;
        float p2[2], ds2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const int col = wn * QW + n * 8 + 2 * tq + j;
          const bool live = mask.live(q0 + col, k0 + krow);
          const float sv = M::kSplitInputs ? s[n][e] + ss[n][e] : s[n][e];
          const float dpv = M::kSplitInputs ? dp[n][e] + dps[n][e] : dp[n][e];
          p2[j] = p_ds(sv * scale, dpv, sLse[col], sDsum[col], live, cap, &ds2[j]);
        }
        const int at = krow * LDP + wn * QW + n * 8 + 2 * tq;
        M::store_split(sP + at, PLANE, p2[0], p2[1]);
        M::store_split(sDS + at, PLANE, ds2[0], ds2[1]);
      }
    __syncthreads();

    // dv += p^T dO and dk += ds^T q: the warp's 16 keys x DW columns, each
    // q tile's product in fresh accumulators, then added
#pragma unroll
    for (int n = 0; n < DN; n += 2) {
      float vm[2][4] = {}, vs[2][4] = {}, km[2][4] = {}, ks[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < BQ; kk += M::KS) {
        typename M::template SA<2> ap, ads;
        M::load_sa(ap, sP, PLANE, LDP, wk * 16, kk);
        M::load_sa(ads, sDS, PLANE, LDP, wk * 16, kk);
        typename M::B b0, b1;
        M::template load_b_kn<false>(b0, b1, sDO, LD, kk, wn * DW + n * 8);
        M::mma(vm[0], vs[0], ap, b0);
        M::mma(vm[1], vs[1], ap, b1);
        M::template load_b_kn<false>(b0, b1, sQ, LD, kk, wn * DW + n * 8);
        M::mma(km[0], ks[0], ads, b0);
        M::mma(km[1], ks[1], ads, b1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          adv[n + j][e] += vm[j][e] + vs[j][e];
          adk[n + j][e] += km[j][e] + ks[j][e];
        }
    }
    __syncthreads();  // every read of this stage and of p^T, ds^T is done
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + wk * 16 + g + 8 * i;
    if (kr >= Skv) continue;
    const long at = ((long)b * Skv + kr) * kstride + (long)kvh * D + wn * DW + 2 * tq;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      store2(dk + at + n * 8, adk[n][2 * i] * scale, adk[n][2 * i + 1] * scale);
      store2(dv + at + n * 8, adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dsum, void* dq, void* dk, void* dv, int B,
                   int H, int KV, int Sq, int Skv, int seq_kv, int causal, int window,
                   float cap, float scale, int q_offset, cudaStream_t st) {
  using Dq = DqTiles<T, D>;
  using Dkv = DkvTiles<T, D>;
  static bool opted_dq[64] = {}, opted_dkv[64] = {};
  cudaError_t err = opt_in(flash_bwd_dq_kernel<T, D>, Dq::kSmem, opted_dq);
  if (err != cudaSuccess) return err;
  err = opt_in(flash_bwd_dkv_kernel<T, D>, Dkv::kSmem, opted_dkv);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* dsum_ = static_cast<const float*>(dsum);
  flash_bwd_dq_kernel<T, D><<<dim3((Sq + kBQ - 1) / kBQ, H, B), Dq::kThreads, Dq::kSmem, st>>>(
      q_, k_, v_, do_, lse_, dsum_, static_cast<T*>(dq), H, KV, Sq, Skv, seq_kv, causal,
      window, cap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D>
      <<<dim3((Skv + Dkv::BKV - 1) / Dkv::BKV, KV, B), kDkvThreads, Dkv::kSmem, st>>>(
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
