// The two ends of a transformer sub-block on Hopper (sm_90a), shared by the
// GEGLU feed-forward (fused_ff.cu) and the temporal attention
// (temporal_attention.cu), bf16 in and out:
//
//   z = LN(x)                              launch_ln   (ln_kernel)
//   y = bf16(bf16(a W^T) + b) [+ res]      launch_out  (out_kernel: OutOp on
//                                          the persistent_gemm.cuh mainloop)
//   y = a W^T, fp32                        launch_out with partial: OutOp's
//                                          kPartial epilogue
//
// The LayerNorm rounds as the TPU kernels' (fused_ff.py _ln_tile,
// temporal_attention.py _attn_stage): fp32 statistics, the variance E[x^2]
// - mean^2 clamped at 0, the fp32 affine, one rounding to bf16. The
// out-GEMM's epilogue rounds as theirs: bf16(acc), + b rounded, + the
// residual rounded (fused_ff.py:246-247, temporal_attention.py:373-376).
//
// What bounds them on the H100: the LayerNorm its bytes (a row read and
// written, a few fp32 operations an element); the out-GEMM, 2 N K Cout
// operations on 2 N (K + 2 Cout) bytes, its bytes at K = 320 (about K
// operations a byte, the card's ratio is ~295) and its operations above.
//
// Every kernel is a template on the caller's Tag (an incomplete type of its
// own namespace), so each library's kernels carry their caller's name in a
// trace (fused_ff::Tag, tattn::Tag) while the code exists once.
//
// OutOp: BM rows x BN output columns a warpgroup tile, A the (n x K)
// activations, B the (Cout x K) weight in torch's Linear layout, K-major.
// The staging area holds the output tile, BN / 32 boxes of 32 columns in
// the 64-byte swizzle; it first takes in the residual tile by TMA while the
// products run. The residual may be the output itself (in place): each tile
// reads its residual before it stores the same tile, and no other tile
// touches it. One thread stores the tile by TMA, which leaves rows past n
// and columns past Cout out; rows past n arrive as zeros.
//
// kPartial (tensor parallelism: a rank holds part of K, the heads or the
// hidden width): the epilogue writes the fp32 accumulator itself, with no
// bias, no residual and no rounding, so that the sum over the ranks is the
// whole accumulator and the bias, the residual and the roundings are applied
// once after it. Each thread stores its two adjacent columns of a row as
// one 8-byte store straight to device memory (a warp's stores of a row span
// 32 bytes, one whole sector), masked at n and Cout; the staging area goes
// unused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "persistent_gemm.cuh"
#include "sm90.cuh"

namespace lnout {

using pgemm::kBK;

// eight bf16 (16 bytes) as floats
__device__ __forceinline__ void ld_bf16x8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// the LayerNorm: one warp a row, 16-byte loads and stores
// ---------------------------------------------------------------------------

constexpr int kLnRows = 8;  // rows (warps) a block

// z for the 8 columns of x from k: the fp32 affine, one rounding to bf16
__device__ __forceinline__ uint4 ln8(const float (&xv)[8], float mean,
                                    float rstd, const float* lnw,
                                    const float* lnb, int k) {
  const float4 w0 = *reinterpret_cast<const float4*>(lnw + k);
  const float4 w1 = *reinterpret_cast<const float4*>(lnw + k + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(lnb + k);
  const float4 b1 = *reinterpret_cast<const float4*>(lnb + k + 4);
  const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  float zf[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) zf[e] = (xv[e] - mean) * rstd * wv[e] + bv[e];
  return make_uint4(pack_bf16(zf[0], zf[1]), pack_bf16(zf[2], zf[3]),
                    pack_bf16(zf[4], zf[5]), pack_bf16(zf[6], zf[7]));
}

// A lane takes the row's 16-byte chunks lane, lane + 32, ...; NCH > 0: at
// most NCH of them, kept in registers between the statistics and the affine
// (C <= 256 NCH); NCH = 0: any C, the row read twice.
template <class Tag, int NCH>
__global__ void __launch_bounds__(kLnRows * 32)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
          const float* __restrict__ lnb, bf16* __restrict__ z, int n, int c,
          float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= n) return;
  const bf16* xr = x + row * c;
  bf16* zr = z + row * c;
  float v[NCH > 0 ? NCH : 1][8];
  float s = 0.f, s2 = 0.f;
  auto add = [&](const float (&u)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += u[e];
      s2 += u[e] * u[e];
    }
  };
  if constexpr (NCH > 0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k < c) {
        ld_bf16x8(xr + k, v[i]);
        add(v[i]);
      }
    }
  } else {
    for (int k = lane * 8; k < c; k += 256) {
      ld_bf16x8(xr + k, v[0]);
      add(v[0]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / c;
  const float var = fmaxf(s2 / c - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if constexpr (NCH > 0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k < c)
        *reinterpret_cast<uint4*>(zr + k) =
            ln8(v[i], mean, rstd, lnw, lnb, k);
    }
  } else {
    for (int k = lane * 8; k < c; k += 256) {
      ld_bf16x8(xr + k, v[0]);
      *reinterpret_cast<uint4*>(zr + k) = ln8(v[0], mean, rstd, lnw, lnb, k);
    }
  }
}

template <class Tag, int NCH>
int launch_ln_rows(const bf16* x, const float* lnw, const float* lnb, bf16* z,
                   int n, int c, float eps, cudaStream_t stream) {
  ln_kernel<Tag, NCH><<<(n + kLnRows - 1) / kLnRows, kLnRows * 32, 0,
                        stream>>>(x, lnw, lnb, z, n, c, eps);
  return (int)cudaGetLastError();
}

// z (n, c) = LN(x (n, c)), c % 8 == 0. Rows of up to 768 columns stay in
// registers; at C = 1280 reading the row twice was faster (fewer registers,
// more rows in flight).
template <class Tag>
int launch_ln(const void* x, const float* lnw, const float* lnb, void* z,
              int n, int c, float eps, cudaStream_t s) {
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* zb = static_cast<bf16*>(z);
  const int nch = (c + 255) / 256;
  return nch == 1   ? launch_ln_rows<Tag, 1>(xb, lnw, lnb, zb, n, c, eps, s)
         : nch == 2 ? launch_ln_rows<Tag, 2>(xb, lnw, lnb, zb, n, c, eps, s)
         : nch == 3 ? launch_ln_rows<Tag, 3>(xb, lnw, lnb, zb, n, c, eps, s)
                    : launch_ln_rows<Tag, 0>(xb, lnw, lnb, zb, n, c, eps, s);
}

// ---------------------------------------------------------------------------
// the out-GEMM, y (n x cols) = bf16(bf16(a (n x K) w (cols x K)^T) + b) [+ res]
// ---------------------------------------------------------------------------

struct OutParams {
  const bf16* bias;  // (cols)
  const bf16* res;   // (n, cols), or null: no residual; may be `out`
  bf16* out;         // (n, cols)
  float* acc;        // (n, cols), fp32: the kPartial epilogue's output
  int n;             // token rows
  int cols;          // output columns
  int kblocks;       // ceil(K / 64)
  int ntiles;        // column tiles
  int tiles;         // row tiles x column tiles
};

template <int BM, int BN, bool kPartial = false>
struct OutOp {
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int kStaging = kPartial ? 0 : BM * BN * 2;
  static constexpr int kExtra = 0;
  OutParams p;
  const CUtensorMap* tm_a;
  const CUtensorMap* tm_b;
  const CUtensorMap* tm_c;
  const CUtensorMap* tm_x;

  // the tile's first row and first output column
  struct Tile {
    int m0, n0;
  };

  __device__ __forceinline__ Tile tile(int t) const {
    return {(t / p.ntiles) * BM, (t % p.ntiles) * BN};
  }
  __device__ __forceinline__ int tiles() const { return p.tiles; }
  __device__ __forceinline__ int kblocks() const { return p.kblocks; }

  // A's rows m0..; B's BN rows n0.. as two boxes of BN / 2
  __device__ __forceinline__ void load(void* a, void* b, uint64_t* bar,
                                       const Tile& c, int kb) const {
    unsigned char* sb = static_cast<unsigned char*>(b);
    sm90::tma_load_2d(a, tm_a, bar, kb * kBK, c.m0);
    sm90::tma_load_2d(sb, tm_b, bar, kb * kBK, c.n0);
    sm90::tma_load_2d(sb + BN * kBK, tm_b, bar, kb * kBK, c.n0 + BN / 2);
  }

  // the residual tile, once the last store read the staging area
  __device__ __forceinline__ void before(const Tile& c, unsigned char* stage,
                                         unsigned char*,
                                         uint64_t* xbar) const {
    if (kPartial || p.res == nullptr) return;
    sm90::bulk_wait_read<0>();
    sm90::mbar_expect_tx(xbar, kStaging);
    for (int b = 0; b < BN / 32; ++b)
      sm90::tma_load_2d(stage + b * BM * 64, tm_x, xbar, c.n0 + 32 * b,
                        c.m0);
  }

  // y = bf16(bf16(acc) + b), then + res rounded, into the staging tile
  // (box j / 4 of 32 columns, its 16-byte chunk c of row r at c ^ ((r / 2)
  // % 4): conflict-free); one thread stores it by TMA
  __device__ __forceinline__ void epilogue(float (&acc)[BM / 64][BN / 2],
                                           const Tile& c, int parity,
                                           int wgi, unsigned char* stage,
                                           unsigned char*,
                                           uint64_t* xbar) const {
    constexpr int kMT = BM / 64;
    const int m0 = c.m0, n0 = c.n0;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2, t4 = lane & 3;
    if constexpr (kPartial) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t4;  // cols % 8 == 0: both or none
        if (col >= p.cols) continue;
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long row = m0 + 64 * mi + 16 * warp + g + 8 * r;
            if (row < p.n)
              *reinterpret_cast<float2*>(p.acc + row * p.cols + col) =
                  make_float2(acc[mi][4 * j + 2 * r],
                              acc[mi][4 * j + 2 * r + 1]);
          }
      }
      return;
    }
    const bool res = p.res != nullptr;
    if (res)
      sm90::mbar_wait(xbar, parity);
    else
      pgemm::epi_wait_staging(wgi);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      const float2 c2 =
          col < p.cols ? ld_bf162(p.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * mi + 16 * warp + g + 8 * r;
          uint32_t* px = reinterpret_cast<uint32_t*>(
              stage + (j / 4) * BM * 64 + row * 64 +
              (((j & 3) ^ ((row >> 1) & 3)) << 4) + 4 * t4);
          float y0 = round_bf16(round_bf16(acc[mi][4 * j + 2 * r]) + c2.x);
          float y1 =
              round_bf16(round_bf16(acc[mi][4 * j + 2 * r + 1]) + c2.y);
          if (res) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(px));
            y0 += xv.x;
            y1 += xv.y;
          }
          *px = pack_bf16(y0, y1);
        }
    }
    pgemm::epi_publish(wgi);
    if ((threadIdx.x & 127) == 0) {
      for (int b = 0; b < BN / 32; ++b)
        sm90::tma_store_2d(tm_c, stage + b * BM * 64, n0 + 32 * b, m0);
      sm90::bulk_commit();
    }
  }
};

template <class Tag, int BM, int BN, bool kPartial>
__global__ void __launch_bounds__(pgemm::kThreads, 1)
out_kernel(const OutParams p, const __grid_constant__ CUtensorMap tm_a,
           const __grid_constant__ CUtensorMap tm_b,
           const __grid_constant__ CUtensorMap tm_c,
           const __grid_constant__ CUtensorMap tm_x) {
  extern __shared__ unsigned char smem_raw[];
  const OutOp<BM, BN, kPartial> op{p, &tm_a, &tm_b, &tm_c, &tm_x};
  pgemm::run(op, smem_raw);
}

// a (rows x k) bf16 row-major tensor, boxes of 64 columns x `box_rows` in
// the 128-byte swizzle, or of 32 columns in the 64-byte one
inline int make_map(CUtensorMap* map, const void* base, int k, int rows,
                    int box_rows, int box_cols = kBK) {
  const uint64_t dims[2] = {(uint64_t)k, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)k * 2};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return sm90_host::make_map(map, base, 2, dims, strides, box,
                             box_cols == kBK ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <class Tag, int BM, int BN, bool kPartial>
int launch_out_tiles(OutParams p, const void* a, const void* w, int k,
                     int grid, cudaStream_t stream) {
  using R = pgemm::RingOf<OutOp<BM, BN, kPartial>>;
  p.kblocks = (k + kBK - 1) / kBK;
  p.ntiles = (p.cols + BN - 1) / BN;
  p.tiles = ((p.n + BM - 1) / BM) * p.ntiles;
  if (grid < 1 || grid > p.tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc, tx;  // A, B, the output, the residual
  int err = make_map(&ta, a, k, p.n, BM);
  if (!err) err = make_map(&tb, w, k, p.cols, BN / 2);
  if (err) return err;
  if (!kPartial) {  // the partial epilogue stores without a tensor map
    err = make_map(&tc, p.out, p.cols, p.n, BM, 32);
    if (!err && p.res != nullptr)
      err = make_map(&tx, p.res, p.cols, p.n, BM, 32);
    else
      tx = tc;
    if (err) return err;
  }
  auto kernel = out_kernel<Tag, BM, BN, kPartial>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, pgemm::kThreads, R::kBytes, stream>>>(p, ta, tb, tc, tx);
  return (int)cudaGetLastError();
}

template <class Tag, bool kPartial>
int launch_out_as(const OutParams& p, const void* a, const void* w, int k,
                  int bm, int bn, int grid, cudaStream_t s) {
  if (bm == 128 && bn == 160)
    return launch_out_tiles<Tag, 128, 160, kPartial>(p, a, w, k, grid, s);
  if (bm == 128 && bn == 128)
    return launch_out_tiles<Tag, 128, 128, kPartial>(p, a, w, k, grid, s);
  if (bm == 64 && bn == 160)
    return launch_out_tiles<Tag, 64, 160, kPartial>(p, a, w, k, grid, s);
  if (bm == 64 && bn == 128)
    return launch_out_tiles<Tag, 64, 128, kPartial>(p, a, w, k, grid, s);
  return (int)cudaErrorInvalidValue;
}

// y (n, cols) from a (n, k), w (cols, k), bias (cols) and res (n, cols) or
// null, in bm (64 or 128) x bn (128 or 160) tiles on `grid` persistent
// blocks (at most its tiles); cols % 8 == 0.
template <class Tag>
int launch_out(const void* a, const void* w, const void* bias,
               const void* res, void* out, int n, int k, int cols, int bm,
               int bn, int grid, cudaStream_t s) {
  OutParams p{};
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.n = n;
  p.cols = cols;
  return launch_out_as<Tag, false>(p, a, w, k, bm, bn, grid, s);
}

// The partial out-GEMM: acc (n, cols) fp32 = a (n, k) w (cols, k)^T, no
// bias, no residual, no rounding; tiles as launch_out's.
template <class Tag>
int launch_out_partial(const void* a, const void* w, float* acc, int n,
                       int k, int cols, int bm, int bn, int grid,
                       cudaStream_t s) {
  OutParams p{};
  p.acc = acc;
  p.n = n;
  p.cols = cols;
  return launch_out_as<Tag, true>(p, a, w, k, bm, bn, grid, s);
}

}  // namespace lnout
