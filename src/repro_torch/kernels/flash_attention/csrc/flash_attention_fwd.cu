// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++
// with a plain C interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/flash_attention/kernel.py:flash_attention_pallas.
//
// Computes, for each batch b, query head h and query row r (position
// qpos = q_offset + r), over the keys of KV head h / (H / KV):
//   s[kpos]  = scale * (q . k[kpos])          scale = 1 / sqrt(D), in fp32
//   s        = cap * tanh(s / cap)            when a cap is set
//   live     = kpos < seq_kv, and kpos <= qpos when causal, and
//              qpos - kpos < window when a window is set
//   s        = live ? s : -2e38               (the reference kernel's NEG_INF)
//   o        = sum_k softmax(s)_k v[k]        written in the inputs' type
//   lse      = m + log(max(l, 1e-30))         fp32, for the backward
// through the reference's online softmax: per tile of keys, m' = max(m,
// max s), p = exp(s - m'), l' = l exp(m - m') + sum p, acc' = acc exp(m -
// m') + p v; o = acc / max(l, 1e-30). The inputs are fp32 or bf16, read
// in [B, S, heads, D] layout (no transposes). Both products run on the
// tensor cores with fp32 accumulation (flash_attention_common.cuh):
// q k^T exactly in bf16 for bf16 inputs, p v with p split into three bf16
// terms; for fp32 inputs both as 3xTF32. The reference scales q before
// q k^T; here the scale multiplies the fp32 sum (one rounding apart; the
// same value for D 16, 64 and 256).
//
// Bound. At the serving prefill (B 8, H 8, KV 4, S 2048, D 256, causal)
// the function must move Q, K, V and the output once, about 200 MB, for
// 137 GFLOP of products. In bf16 that is q k^T once and p v three times
// (the split) at the tensor cores' 989 TFLOP/s, ~0.28 ms, against ~0.06 ms of
// device memory: bound by operations, the tensor cores'. fp32 inputs run
// three tf32 products per product at 495 TFLOP/s.
//
// What the design does about that bound:
//   * A block owns one (b, h, 64-row q tile), four warps of 16 query rows
//     each, and loops over the kv tiles itself (the TPU grid walks them in
//     order and carries the softmax state in scratch; GPU blocks run in no
//     order). Where one block fills an SM's shared memory (fp32 at D 256),
//     a second group of four warps takes the other half of each tile's
//     keys with its own softmax state, merged at the end, so 8 warps
//     share the SM. A warp keeps its rows' m, l and [16, D] accumulator in
//     registers, as mma accumulator fragments; the row max and sum of the
//     online softmax are shuffles over the 4 lanes that share a row, and
//     p goes from the score accumulators straight into the A operand of
//     p v (no shared-memory round trip).
//   * Tiles stay in the inputs' type in shared memory (bf16 tiles are not
//     widened), rows padded by 16 bytes so ldmatrix reads no bank twice.
//     Q is loaded once; K and V come in a ring of two stages by 16-byte
//     `cp.async`, the next tile in flight while the current one is used.
//     BK = 64 keys per tile (32 at D 256, and for fp32 at D 128): 99 KB
//     of shared memory at D 256 in bf16, so two blocks share an SM, 195
//     KB in fp32; opted in once per kernel and device.
//   * Tiles with no live key for any row of the block (above the causal
//     diagonal, behind the sliding window, past seq_kv) are not visited.
//     They would add nothing: a visited row always has a live key (the
//     wrapper refuses rows with none), and the reference's own update
//     wipes what a row accumulated before its first live key (its
//     exp(m - m') is 0 once a live score arrives).
//   * The GQA repeat is never built: a block reads K and V of head
//     h / (H / KV) in place.
//   * Blocks of the causal prefill differ in work by their q tile; the grid
//     starts the longest ones (the last q tiles) first.

#include "flash_attention_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block: four row warps of 16

template <typename T, int D>
struct FwdTiles {
  using M = typename MmaOf<T>::type;
  static constexpr int BK = (D == 256 || (sizeof(T) == 4 && D >= 128)) ? 32 : 64;  // keys
  static constexpr int LD = D + M::EPC;                              // row stride (elements)
  static constexpr size_t kSmem = (size_t)(kBQ + 4 * BK) * LD * sizeof(T);  // Q, 2 x (K, V)
  // Where one block fills an SM's shared memory (fp32 at D 256), two groups
  // of four warps split each tile's keys, so 8 warps, not 4, hide latency
  static constexpr int KSPLIT = kSmem > kMaxSmem / 2 ? 2 : 1;
  static constexpr int kThreads = 128 * KSPLIT;
  static constexpr int BKG = BK / KSPLIT;  // a warp group's keys of each tile
  static_assert(kSmem <= kMaxSmem, "shared memory");
  static_assert(KSPLIT == 1 || (size_t)kBQ * (D + 2) * 4 <= (size_t)4 * BK * LD * sizeof(T),
                "the groups' merge fits the K/V stages");
};

// grid (ceil(Sq / 64), H, B), 128 threads (256 with KSPLIT 2). q, o
// [B, Sq, H, D]; k, v [B, Skv, KV, D]; lse [B, H, Sq]. window <= 0: none;
// cap <= 0: none.
template <typename T, int D>
__global__ void __launch_bounds__(FwdTiles<T, D>::kThreads, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int KV, int Sq, int Skv,
    int seq_kv, int causal, int window, float cap, float scale, int q_offset) {
  using Tl = FwdTiles<T, D>;
  using M = typename Tl::M;
  constexpr int BK = Tl::BK, BKG = Tl::BKG, LD = Tl::LD, NT = BKG / 8, DT = D / 8;
  constexpr int kThreads = Tl::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* sKV = sQ + kBQ * LD;                  // 2 stages x ([BK][LD] K, [BK][LD] V)

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int rw = (threadIdx.x >> 5) & 3;  // row warp: rows rw * 16 ..
  const int grp = threadIdx.x >> 7;       // warp group: keys grp * BKG .. of each tile
  const int ko = grp * BKG;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const long qstride = (long)H * D;
  const long kstride = (long)KV * D;
  const T* qb = q + ((long)b * Sq + q0) * qstride + (long)h * D;
  const long kvoff = (long)b * Skv * kstride + (long)(h / (H / KV)) * D;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;

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
    load_tile<T, BK, D, LD, kThreads>(sK, kb + k0 * kstride, kstride, min(BK, Skv - k0));
    load_tile<T, BK, D, LD, kThreads>(sK + BK * LD, vb + k0 * kstride, kstride,
                                      min(BK, Skv - k0));
  };
  load_tile<T, kBQ, D, LD, kThreads>(sQ, qb, qstride, min(kBQ, Sq - q0));
  if (t_beg < t_end) load_kv(t_beg, 0);
  cp_async_commit();

  // this lane's rows: i = 0 is row rw * 16 + g, i = 1 row + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int r0 = q0 + rw * 16 + g;
  const Mask mask{Sq, seq_kv, causal, window, q_offset};

  for (int t = t_beg; t < t_end; ++t) {
    const int stage = (t - t_beg) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);  // in flight while this tile is used
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    const T* sK = sKV + stage * 2 * BK * LD;
    const T* sV = sK + BK * LD;

    // s = q k^T for the warp's 16 rows and its group's BKG keys of the tile
    // (ss: the small terms of 3xTF32)
    float s[NT][4], ss[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ss[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::KS) {
      typename M::A a;
      M::load_a(a, sQ, LD, rw * 16, kk);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, sK, LD, ko + n * 8, kk);
        M::mma(s[n], ss[n], a, b0);
        M::mma(s[n + 1], ss[n + 1], a, b1);
      }
    }
    if constexpr (M::kSplitInputs) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += ss[n][e];
    }

    // scale, soft-cap, mask; the online softmax on the fragments
    const int k0 = t * BK;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + ko + n * 8 + 2 * tq + (e & 1);
        float x = s[n][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        s[n][e] = mask.live(r0 + 8 * i, kpos) ? x : kNegInf;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        ps[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(ps[i]);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p v over this tile's keys: p in three bf16 terms (or big +
    // small tf32), the tile's product in fresh accumulators (tm, and ts for
    // the small terms), then added to acc
    typename M::template SA<3> pa[BKG / M::KS];
#pragma unroll
    for (int kk = 0; kk < BKG / M::KS; ++kk) M::template from_acc<3>(pa[kk], s, kk);
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      float tm[2][4] = {}, ts[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < BKG / M::KS; ++kk) {
        typename M::B b0, b1;
        M::template load_b_kn<true>(b0, b1, sV, LD, ko + kk * M::KS, n * 8);
        M::mma(tm[0], ts[0], pa[kk], b0);
        M::mma(tm[1], ts[1], pa[kk], b1);
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
    // merge group 1's (m, l, acc) into group 0's through the free K/V stages
    float* xa = reinterpret_cast<float*>(sKV);  // [64][D]
    float* xm = xa + kBQ * D;                   // [64] m, then [64] l
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rw * 16 + g + 8 * i;
        if (tq == 0) {
          xm[row] = m[i];
          xm[kBQ + row] = l[i];
        }
#pragma unroll
        for (int n = 0; n < DT; ++n)
          store2(xa + row * D + n * 8 + 2 * tq, acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rw * 16 + g + 8 * i;
      const float m1 = xm[row], mm = fmaxf(m[i], m1);
      const float a0 = expf(m[i] - mm), a1 = expf(m1 - mm);
      l[i] = l[i] * a0 + xm[kBQ + row] * a1;
      m[i] = mm;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(xa + row * D + n * 8 + 2 * tq);
        acc[n][2 * i] = acc[n][2 * i] * a0 + x.x * a1;
        acc[n][2 * i + 1] = acc[n][2 * i + 1] * a0 + x.y * a1;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rw * 16 + g + 8 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long)b * Sq + r) * qstride + (long)h * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(orow + n * 8 + 2 * tq, acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    if (tq == 0) lse[((long)b * H + h) * Sq + r] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int KV, int Sq, int Skv, int seq_kv, int causal,
                   int window, float cap, float scale, int q_offset, cudaStream_t st) {
  const size_t smem = FwdTiles<T, D>::kSmem;
  static bool opted[64] = {};
  const cudaError_t err = opt_in(flash_fwd_kernel<T, D>, smem, opted);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, FwdTiles<T, D>::kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, KV, Sq, Skv, seq_kv, causal,
      window, cap, scale, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int KV, int Sq, int Skv, int seq_kv,
                     int causal, int window, float cap, float scale, int q_offset,
                     cudaStream_t st) {
#define FLASH_CASE(DD)                                                                   \
  case DD:                                                                               \
    return launch<T, DD>(q, k, v, o, lse, B, H, KV, Sq, Skv, seq_kv, causal, window, cap, \
                         scale, q_offset, st);
  switch (D) {
    FLASH_HEAD_DIMS(FLASH_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a head width without a
// kernel). The caller checks shapes, strides and alignment.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int dtype, int B, int H, int KV, int Sq, int Skv, int D, int seq_kv,
                     int causal, int window, float cap, float scale, int q_offset,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, lse, B, H, KV, Sq, Skv, seq_kv, causal,
                                window, cap, scale, q_offset, st);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, KV, Sq, Skv, seq_kv,
                                        causal, window, cap, scale, q_offset, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
