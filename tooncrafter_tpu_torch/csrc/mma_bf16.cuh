// Small device helpers shared by the fused kernels (temporal_attention.cu,
// temporal_ptc.cu, dual_cross_attention.cu, group_norm_silu.cu,
// gn_silu_conv3x3.cu; temporal_conv.cu for the bf16 packing): bf16 packing
// and rounding, the fast SiLU, fragment loads, and the m16n8k16 bf16
// tensor-core product.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                   a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g), i.e. two
//                   32-bit loads from row g of B^T stored K-contiguous
//   C (16x8):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// v * sigmoid(v) with the approximate exponential and reciprocal (a few
// fp32 ulps, far below the bf16 rounding that follows; the IEEE-rounded
// reciprocal, or __expf's range fix-up, cost instructions that the conv's
// prologue, which sets its pace, and the GroupNorm's apply cannot spare)
__device__ __forceinline__ float fast_silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_bf162(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, transposed: lane i receives elements (2 (i % 4), i / 4) and
// (2 (i % 4) + 1, i / 4) of each 8x8 matrix, i.e. the B fragment of a
// (k x n) operand stored k-major (rows = k). Lanes 0-15 give the row
// addresses of the two matrices.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// ldmatrix x4 (or x4.trans) at shared address `a` (a cvta'd shared-window
// address) plus the constant byte offset kOff, which rides in the
// instruction: the fragments of a swizzled tile's row groups 16 rows apart
// share one address register
template <int kOff, bool kTrans = false>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4+%5];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a), "n"(kOff));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
        "[%4+%5];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a), "n"(kOff));
}

// Four 8x8 b16 matrices, each transposed (ldmatrix_x2_trans's x4 form): from
// a (k x n) operand stored k-major, matrices (k 0-7, n 0-7), (k 8-15, n
// 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) give b0, b1 of two n8 tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  ldsm_x4<0, true>(r, static_cast<uint32_t>(__cvta_generic_to_shared(p)));
}

// 32 bits into shared memory at a cvta'd shared-window address (a store
// through a generic pointer costs the address-space check)
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// f(Int<0>) .. f(Int<N - 1>): an unrolled loop whose index is a constant
// expression (decltype(i)::value)
template <int I>
struct Int {
  static constexpr int value = I;
};
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, I...>) {
  (f(Int<I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile of
// 128-byte rows stored in the 128-byte swizzle (chunk c of row r at chunk
// c ^ (r % 8), as TMA writes it; sm90.cuh), from a 1024-byte aligned base.
// ldmatrix reads eight such rows at one chunk conflict-free.
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// K-contiguous operands without a permuted copy. A product over 32 k values
// may visit them in any order, so two k16 steps over columns [k, k + 32)
// give lane t of a quad the columns k + 8t .. k + 8t + 7: step s's slots
// (2t, 2t + 1) hold columns k + 8t + 4s + (0, 1) and slots (2t + 8, 2t + 9)
// columns k + 8t + 4s + (2, 3). Then a B operand stored (n, K) row-major
// (torch's Linear weight) gives a lane both steps' fragments in one 16-byte
// load of row n = g (words x, y for step 0, z, w for step 1), and the A
// fragments are two 16-byte loads of rows g and g + 8 of the shared tile
// (conflict-free where ld * 2 bytes is 64 modulo 128).
__device__ __forceinline__ uint4 lds128(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void load_a_k32(uint32_t a[2][4], const bf16* tile,
                                           int ld, int r0, int k, int lane) {
  const bf16* p = tile + (r0 + (lane >> 2)) * ld + k + 8 * (lane & 3);
  const uint4 lo = lds128(p), hi = lds128(p + 8 * ld);
  a[0][0] = lo.x; a[0][1] = hi.x; a[0][2] = lo.y; a[0][3] = hi.y;
  a[1][0] = lo.z; a[1][1] = hi.z; a[1][2] = lo.w; a[1][3] = hi.w;
}

// Row stride (elements) of a shared tile of `cols` columns for load_a_k32:
// padded so that ld * 2 bytes is 64 modulo 128 (cols % 32 == 0).
__host__ __device__ constexpr int k32_stride(int cols) {
  return cols % 64 == 0 ? cols + 32 : cols;
}
