// Device helpers shared by the flash-attention forward
// (flash_attention_fwd.cu) and backward (flash_attention_bwd.cu)
// kernels: the constants, the list of head widths, 16-byte `cp.async`
// tile loads into padded shared-memory rows, `ldmatrix` and `mma.sync`
// wrappers, the two operand paths of the tensor-core products (`MmaBf16`
// for bf16 inputs, `MmaF32` for fp32 inputs), the row mask and the
// shared-memory opt-in. Each .cu includes it; the build hashes it with
// each source, so an edit here rebuilds both.
//
// The products, and why they are the reference's function to fp32
// tolerance:
//   * bf16 inputs (`MmaBf16`): q k^T and dO v^T multiply bf16 values, and
//     the product of two bf16 values is exact in fp32, so
//     `mma.m16n8k16.bf16` with fp32 accumulation gives them to fp32
//     accuracy. An operand that is fp32 (p, ds) is split into bf16 terms,
//     hi = bf16(x), lo = bf16(x - hi), ...: p of the forward into three
//     (about 24 bits of p: its output is held to one bf16 ulp even near
//     0), p and ds of the backward into two (about 16 bits), one product
//     each.
//   * fp32 inputs (`MmaF32`): 3xTF32. Each fp32 operand is split into
//     big = tf32(x) (to nearest, ties away from zero) and small = x - big,
//     of which the mma reads the top 19 bits: about 21 bits of x, and a
//     product is the three `mma.m16n8k8.tf32` small*big, big*small,
//     big*big (the dropped small*small is below 2^-22 of it).
//   * Neither path scales q before a product: the scale multiplies the
//     fp32 sum (for D 16, 64 and 256 a power of two, so the same value).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the head widths with a kernel: X(16) X(32) ... for a case list
#define FLASH_HEAD_DIMS(X) X(16) X(32) X(64) X(128) X(256)

namespace {

constexpr float kNegInf = -2.0e38f;  // the reference kernel's own NEG_INF
constexpr size_t kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// cp.async: 16-byte (and 4-byte) copies from device to shared memory that
// the issuing thread does not wait for; a row past the valid ones is
// zero-filled (src-size 0), so a ragged tile multiplies as zeros.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, ROWS) of D elements, row r at g + r * gstride, into shared
// rows of LD elements; rows >= valid are zeros. All NTHR threads take part.
template <typename T, int ROWS, int D, int LD, int NTHR>
__device__ __forceinline__ void load_tile(T* s, const T* g, long gstride, int valid) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHR) {
    const int r = c / CPR;
    const int cc = c - r * CPR;
    const bool ok = r < valid;
    cp_async16(s + r * LD + cc * EPC, ok ? g + r * gstride + cc * EPC : g, ok);
  }
}

// ---------------------------------------------------------------------------
// ldmatrix and mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The operand paths. Fragments follow the PTX ISA's layouts for
// m16n8k16 (bf16) and m16n8k8 (tf32): lane = 4 g + t; an accumulator
// tile c[4] holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
// Every tile in shared memory is row-major with LD = width + 16 bytes,
// so the eight 16-byte rows an ldmatrix reads fall on distinct banks.
//   load_a(a, s, ld, r0, k0):  A rows r0.., k k0.. of a row-major [m][k]
//   load_b_nk(b0, b1, ...):    B of n-tiles n0 and n0 + 8 from an [n][k] tile
//                              (load_b_nk1: the one n-tile n0)
//   load_b_kn<PERM>(...):      the same from a [k][n] tile; PERM where the
//                              A operand came from accumulators (below)
//   from_acc<N>(a, c, kk):     the A operand of k-step kk from accumulator
//                              tiles, split (p and ds are fp32): SA<N>
//   store_split / load_sa:     an fp32 operand through shared memory, as
//                              kPlanes planes (bf16: hi and lo; fp32: one)
//   mma(cm, cs, a, b):         cm += the product's leading term, cs += its
//                              small terms (a separate accumulator, so
//                              they are not cut against cm's magnitude)
// The tensor cores' fp32 accumulation is not IEEE (the products of one
// mma are aligned to the largest addend and cut), so the kernels keep
// each chain short: a fresh accumulator per tile, added to the running
// sum with an IEEE fp32 add.
// ---------------------------------------------------------------------------

struct MmaBf16 {
  using T = __nv_bfloat16;
  static constexpr int KS = 16;  // k per mma
  static constexpr int EPC = 8;  // elements per 16 bytes
  static constexpr bool kSplitInputs = false;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };
  template <int N>
  struct SA { A t[N]; };  // an fp32 operand as N bf16 terms, largest first

  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld, int r0, int k0) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(a.x, s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  }
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const T* s, int ld, int n0,
                                                   int k0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldsm_x4(r, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
    b0.x[0] = r[0]; b0.x[1] = r[1]; b1.x[0] = r[2]; b1.x[1] = r[3];
  }
  // one n-tile (n0..n0+7) from an [n][k] tile (lanes 0-15 give the rows)
  static __device__ __forceinline__ void load_b_nk1(B& b, const T* s, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31;
    ldsm_x2(b.x, s + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
  }
  template <bool PERM>
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const T* s, int ld, int k0,
                                                   int n0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldsm_x4_trans(r, s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
    b0.x[0] = r[0]; b0.x[1] = r[1]; b1.x[0] = r[2]; b1.x[1] = r[3];
  }
  // x, y (adjacent columns) as N packed bf16x2 terms
  template <int N>
  static __device__ __forceinline__ void split(float x, float y, SA<N>& a, int reg) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      a.t[i].x[reg] = *reinterpret_cast<const uint32_t*>(&h);
      x -= __low2float(h);
      y -= __high2float(h);
    }
  }
  // k-step kk spans accumulator tiles 2 kk (k 0..7) and 2 kk + 1 (k 8..15),
  // in the A layout as they are
  template <int N>
  static __device__ __forceinline__ void from_acc(SA<N>& a, float (*c)[4], int kk) {
    const float* c0 = c[2 * kk];
    const float* c1 = c[2 * kk + 1];
    split<N>(c0[0], c0[1], a, 0);
    split<N>(c0[2], c0[3], a, 1);
    split<N>(c1[0], c1[1], a, 2);
    split<N>(c1[2], c1[3], a, 3);
  }
  // a two-term operand in shared memory: its hi plane at s, its lo plane at
  // s + plane
  static constexpr int kPlanes = 2;
  static __device__ __forceinline__ void store_split(T* s, int plane, float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
    *reinterpret_cast<__nv_bfloat162*>(s) = h;
    *reinterpret_cast<__nv_bfloat162*>(s + plane) = l;
  }
  static __device__ __forceinline__ void load_sa(SA<2>& a, const T* s, int plane, int ld, int r0,
                                                 int k0) {
    load_a(a.t[0], s, ld, r0, k0);
    load_a(a.t[1], s + plane, ld, r0, k0);
  }
  // exact bf16 operands: one product, into cm
  static __device__ __forceinline__ void mma(float (&cm)[4], float (&)[4], const A& a,
                                             const B& b) {
    mma_bf16(cm, a.x, b.x[0], b.x[1]);
  }
  template <int N>
  static __device__ __forceinline__ void mma(float (&cm)[4], float (&cs)[4], const SA<N>& a,
                                             const B& b) {
#pragma unroll
    for (int i = N - 1; i > 0; --i) mma_bf16(cs, a.t[i].x, b.x[0], b.x[1]);
    mma_bf16(cm, a.t[0].x, b.x[0], b.x[1]);
  }
};

struct MmaF32 {
  using T = float;
  static constexpr int KS = 8;
  static constexpr int EPC = 4;
  static constexpr bool kSplitInputs = true;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };
  template <int N>
  using SA = A;  // an fp32 operand is always big + small

  // big: x rounded to tf32, to nearest with ties away from zero (add half
  // of the 13 dropped bits to the magnitude, clear them); small = x - big,
  // exact, of either sign, whose low 13 bits the mma drops. Integer and
  // fp32 adds only: a cvt to tf32 issues at a quarter of their rate, and
  // the split runs for every fragment.
  static __device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
    big = (x + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
  }
  template <int N>
  static __device__ __forceinline__ void split_all(const uint32_t* r, uint32_t* big,
                                                   uint32_t* small) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(r[i], big[i], small[i]);
  }
  // ldmatrix on 32-bit elements: a "row" of 16 bytes is 4 floats, and
  // lane 4 g + t receives the float (g, t) of each 8 x 4 matrix, which is
  // the tf32 fragment layout
  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld, int r0, int k0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldsm_x4(r, s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 4);
    split_all<4>(r, a.big, a.small);
  }
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const T* s, int ld, int n0,
                                                   int k0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldsm_x4(r, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 4);
    split_all<2>(r, b0.big, b0.small);
    split_all<2>(r + 2, b1.big, b1.small);
  }
  static __device__ __forceinline__ void load_b_nk1(B& b, const T* s, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[2];
    ldsm_x2(r, s + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 4);
    split_all<2>(r, b.big, b.small);
  }
  // B from a [k][n] tile with scalar loads: b0 = (k t, n g), b1 = (k t + 4,
  // n g); with PERM the k rows 2t and 2t + 1, matching `from_acc`
  template <bool PERM>
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const T* s, int ld, int k0,
                                                   int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* r0 = s + (k0 + (PERM ? 2 * t : t)) * ld + n0 + g;
    const T* r1 = s + (k0 + (PERM ? 2 * t + 1 : t + 4)) * ld + n0 + g;
    const uint32_t x[4] = {__float_as_uint(r0[0]), __float_as_uint(r1[0]),
                           __float_as_uint(r0[8]), __float_as_uint(r1[8])};
    split_all<2>(x, b0.big, b0.small);
    split_all<2>(x + 2, b1.big, b1.small);
  }
  // k-step kk is accumulator tile kk (8 keys), its k order permuted so no
  // value moves between lanes: A's column t is the tile's column 2t, its
  // column t + 4 the tile's 2t + 1 (load_b_kn<true> reads B to match)
  template <int N>
  static __device__ __forceinline__ void from_acc(A& a, float (*c)[4], int kk) {
    const float* x = c[kk];
    const uint32_t r[4] = {__float_as_uint(x[0]), __float_as_uint(x[2]), __float_as_uint(x[1]),
                           __float_as_uint(x[3])};
    split_all<4>(r, a.big, a.small);
  }
  static constexpr int kPlanes = 1;
  static __device__ __forceinline__ void store_split(T* s, int, float x, float y) {
    *reinterpret_cast<float2*>(s) = make_float2(x, y);
  }
  static __device__ __forceinline__ void load_sa(A& a, const T* s, int, int ld, int r0, int k0) {
    load_a(a, s, ld, r0, k0);
  }
  // 3xTF32: small * big and big * small into cs, big * big into cm
  static __device__ __forceinline__ void mma(float (&cm)[4], float (&cs)[4], const A& a,
                                             const B& b) {
    mma_tf32(cs, a.small, b.big[0], b.big[1]);
    mma_tf32(cs, a.big, b.small[0], b.small[1]);
    mma_tf32(cm, a.big, b.big[0], b.big[1]);
  }
};

template <typename T> struct MmaOf;
template <> struct MmaOf<__nv_bfloat16> { using type = MmaBf16; };
template <> struct MmaOf<float> { using type = MmaF32; };

// ---------------------------------------------------------------------------
// rows, masks, output, launch
// ---------------------------------------------------------------------------

// max and sum over the 4 lanes (one quad) that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Mask {
  int Sq, seq_kv, causal, window, q_offset;
  // query row r (of Sq) against key position kpos
  __device__ __forceinline__ bool live(int r, int kpos) const {
    const int qpos = q_offset + r;
    return r < Sq && kpos < seq_kv && (!causal || kpos <= qpos) &&
           (window <= 0 || qpos - kpos < window);
  }
};

// two adjacent output values (x at the lower address) in the output type
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// raise a kernel's dynamic shared-memory limit once per device (the call
// costs host time), after which the flag is set
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
