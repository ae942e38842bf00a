// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++
// with a plain C interface (bound from Python with ctypes).
//
// Replaces: repro/kernels/flash_attention/kernel.py:flash_attention_pallas.
//
// Computes, for each batch b, query head h and query row r (position
// qpos = q_offset + r), over the keys of KV head h / (H / KV):
//   s[kpos]  = (q * scale) . k[kpos]          scale = 1 / sqrt(D), in fp32
//   s        = cap * tanh(s / cap)            when a cap is set
//   live     = kpos < seq_kv, and kpos <= qpos when causal, and
//              qpos - kpos < window when a window is set
//   s        = live ? s : -2e38               (the reference kernel's NEG_INF)
//   o        = sum_k softmax(s)_k v[k]        written in the inputs' type
//   lse      = m + log(max(l, 1e-30))         fp32, for the backward
// through the reference's online softmax: per tile of keys, m' = max(m,
// max s), p = exp(s - m'), l' = l exp(m - m') + sum p, acc' = acc exp(m -
// m') + p v; o = acc / max(l, 1e-30). The inputs are fp32 or bf16, read
// in [B, S, heads, D] layout (no transposes); every product and sum is an
// IEEE fp32 FMA on the inputs upcast to fp32, as the reference computes
// them. (A tensor-core version would round p to bf16 before P.V: another
// function, left for a later change.)
//
// Bound. At the serving prefill (B 8, H 8, KV 4, S 2048, D 256, causal)
// the function must move Q, K, V and the output once, about 200 MB, for
// 137 GFLOP: ~680 flops per byte, ten times the fp32 balance point of the
// card. The kernel is bound by fp32 operations, not by device memory.
//
// What the design does about that bound:
//   * The TPU kernel's grid walks (bh, q tile, kv tile) in order and
//     carries (acc, m, l) in scratch across kv steps; GPU blocks run in no
//     order. Here a block owns one (b, h, 64-row q tile) and loops over the
//     kv tiles itself, with m and l in registers and each thread's part of
//     the [64, D] accumulator in registers (4 rows x D/16 columns).
//   * Tiles with no live key for any row of the block (above the causal
//     diagonal, behind the sliding window, past seq_kv) are not visited.
//     They would add nothing: a visited row always has a live key (the
//     wrapper refuses rows with none), and the reference's own update
//     wipes what a row accumulated before its first live key (its
//     exp(m - m') is 0 once a live score arrives).
//   * The GQA repeat is never built: a block reads K and V of head
//     h / (H / KV) in place.
//   * 256 threads as 16 x 16: thread (ty, tx) computes scores for rows
//     4 ty .. 4 ty + 3 and keys tx + 16 j, and owns output columns of those
//     four rows. Q, K and V tiles sit in shared memory as fp32 rows padded
//     by 4 floats, so each of the thread's 16-byte reads along D falls on
//     a distinct 16-byte bank group (Q reads are broadcasts); one such
//     read feeds 4 or 16 FMAs. P goes through shared memory to the P.V
//     product, which reads V rows as 16-byte words.
//   * The next K/V tile is loaded from device memory into registers while
//     the current one is scored, then converted and stored to shared
//     memory: the loads' latency hides behind the arithmetic.
//   * Blocks of the causal prefill differ in work by their q tile; the grid
//     starts the longest ones (the last q tiles) first.
//   * Shared memory per block: (64 + 2 BK) (D + 4) + 64 (BK + 4) floats,
//     BK = 32 keys per tile for D >= 128 (142 KB at D 256) and 64 below;
//     above 48 KB it is opted in, once per kernel.

#include "flash_attention_common.cuh"

namespace {

template <int D>
struct Tiles : TileShape<D> {
  using S = TileShape<D>;
  static constexpr size_t kSmem =
      (size_t)(kBQ * S::SD + 2 * S::BK * S::SD + kBQ * S::SP) * sizeof(float);
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (ceil(Sq / 64), H, B), 256 threads. q, o [B, Sq, H, D]; k, v
// [B, Skv, KV, D]; lse [B, H, Sq]. window <= 0: none; cap <= 0: none.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int KV, int Sq, int Skv,
    int seq_kv, int causal, int window, float cap, float scale, int q_offset) {
  using Tl = Tiles<D>;
  constexpr int BK = Tl::BK, SD = Tl::SD, SP = Tl::SP, KC = Tl::KC, OC = Tl::OC,
                VEC = Tl::VEC;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [64][SD], scaled
  float* sK = sQ + kBQ * SD;    // [BK][SD]
  float* sV = sK + BK * SD;     // [BK][SD]
  float* sP = sV + BK * SD;     // [64][SP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
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

  {
    TileRegs<T, D, kBQ> qr;
    qr.load(qb, qstride, min(kBQ, Sq - q0));
    qr.store(sQ, scale);
  }
  TileRegs<T, D, BK> kr, vr;
  if (t_beg < t_end) {
    const int k0 = t_beg * BK;
    kr.load(kb + k0 * kstride, kstride, min(BK, Skv - k0));
    vr.load(vb + k0 * kstride, kstride, min(BK, Skv - k0));
  }

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_beg; t < t_end; ++t) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    kr.store(sK, 1.f);
    vr.store(sV, 1.f);
    __syncthreads();
    const int k0 = t * BK;
    if (t + 1 < t_end) {  // in flight while this tile is scored
      const int k1 = k0 + BK;
      kr.load(kb + k1 * kstride, kstride, min(BK, Skv - k1));
      vr.load(vb + k1 * kstride, kstride, min(BK, Skv - k1));
    }

    // scores of rows 4 ty + i, keys tx + 16 j
    float s[4][KC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[KC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * SD + d);
#pragma unroll
      for (int j = 0; j < KC; ++j) kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * SD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // soft-cap, mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qlo + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (cap > 0.f) x = cap * tanhf(x / cap);
        const bool live = kpos < seq_kv && (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = live ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * SP + tx + 16 * j] = p;
        ps += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's keys, in key order
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * SP + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = sV + (c + e) * SD;
        float vv[OC];
#pragma unroll
        for (int g = 0; g < OC / VEC; ++g) {
          const float* src = vrow + g * 16 * VEC + tx * VEC;
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[g * 4] = x.x; vv[g * 4 + 1] = x.y; vv[g * 4 + 2] = x.z; vv[g * 4 + 3] = x.w;
          } else if constexpr (VEC == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[g * 2] = x.x; vv[g * 2 + 1] = x.y;
          } else {
            vv[g] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int cc = 0; cc < OC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long)b * Sq + r) * qstride + (long)h * D;
#pragma unroll
    for (int g = 0; g < OC / VEC; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[g * 16 * VEC + tx * VEC + e] = to_out(acc[i][g * VEC + e] / denom, T());
    if (tx == 0) lse[((long)b * H + h) * Sq + r] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int KV, int Sq, int Skv, int seq_kv, int causal,
                   int window, float cap, float scale, int q_offset, cudaStream_t st) {
  const size_t smem = Tiles<D>::kSmem;
  static bool opted[64] = {};
  const cudaError_t err = opt_in(flash_fwd_kernel<T, D>, smem, opted);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
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

// Dynamic shared memory of the kernel for head width D, in bytes (0 for a
// width without a kernel).
size_t flash_fwd_smem_bytes(int D) {
#define FLASH_SMEM(DD) \
  case DD:               \
    return Tiles<DD>::kSmem;
  switch (D) {
    FLASH_HEAD_DIMS(FLASH_SMEM)
    default:
      return 0;
  }
#undef FLASH_SMEM
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
