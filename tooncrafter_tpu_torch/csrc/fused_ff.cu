// Fused GEGLU feed-forward for Hopper (sm_90a): [LayerNorm] -> x W1^T + b1
// -> h * gelu(g) -> m W2^T + b2 [+ x], bf16 in and out, one kernel.
//
// Replaces the two TPU kernels of tooncrafter_tpu/ops/fused_ff.py:
//   * _pallas_ff           weights resident in VMEM (C <= 640)
//   * _pallas_ff_streamed  weight chunks streamed from HBM (C = 1280)
// The TPU split them only because of VMEM; they compute one function, and
// this one kernel serves both.
//
// What bounds it on the H100: at the UNet's widths the two products do
// 6 * N * C * D operations (D = 4C) on 2 * N * C * 2 bytes of activations;
// at C = 320 that is ~1900 operations per byte, far above the card's ~295,
// so the tensor cores bound it. What the TPU kernel saved, and this one
// keeps: the 2D-wide projection and the D-wide gated product never reach
// device memory (at ds1 that is a 419 MB bf16 tensor per call written and
// read back by the unfused form).
//
// Design. A block takes a tile of BM tokens (64 for Cout <= 320, else 32)
// and walks D in chunks of DK = 8 * warps columns:
//   1. stage z = LN(x) (fp32 statistics, E[x^2] - mean^2 clamped at 0, as
//      the TPU's _ln_tile) for the token tile in shared memory, once;
//   2. per D chunk, each warp computes one n8 tile of h and one of g
//      (K = C, fp32 accumulators), adds b1 and applies the exact erf gate
//      in fp32, rounds m = h * gelu(g) to bf16 into shared memory;
//   3. all warps then accumulate acc += m W2^T over the chunk, each warp
//      owning a slice of the output columns, in fp32 registers.
// Epilogue: acc -> bf16, + b2 (rounded), + x (rounded), as the TPU kernel
// (fused_ff.py:246-247).
//
// The weights' fragments are read from global memory (L2) in torch's Linear
// layout, 16 bytes a thread: both products visit each 32-deep K block in the
// k32 order of mma_bf16.cuh, so one 16-byte load of a weight row gives a
// thread its B fragments for two k16 steps, and the A fragments are two
// 16-byte shared loads; the next step's loads are issued before the current
// step's products.
//
// The C = 1280 trap: a token tile's fp32 output accumulator (tile x Cout x
// 4 bytes) does not fit one warp's registers at a tile that feeds the
// tensor cores. The choice here is a small token tile (32) with the
// accumulator spread over all the block's registers: 16 warps (512
// threads) each hold a 32 x 80 slice (80 floats a thread). Nothing is
// recomputed; the cost is that every 32-token tile reads all of W1 and W2
// (39 MB at C = 1280) again from L2: 160 tiles at the ds4 shape, ~6.3 GB
// of L2 traffic for 0.2 TFLOP. Splitting Cout over blocks instead would
// recompute the 2D-wide projection once per slice (7x the work at 10
// slices). The same holds at C = 320 with 64-token tiles (1280 tiles at
// ds1, ~3 GB of L2 reads).
//
// A simple first version: mma.sync m16n8k16, no shared-memory staging of
// the weights; wgmma, TMA and a producer warp are left for later work.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

struct Params {
  const bf16* x;      // (n, c)
  const bf16* w1;     // (2d, c): h rows, then gate rows
  const bf16* b1;     // (2d)
  const bf16* w2;     // (cout, d)
  const bf16* b2;     // (cout)
  const float* lnw;   // (c) or null: no LayerNorm prologue
  const float* lnb;   // (c)
  bf16* out;          // (n, cout)
  int n, c, d, cout;
  float eps;
  int residual;
};

__device__ __forceinline__ float gelu_exact(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ uint4 ldg128(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// NW warps, MT m16 row tiles (BM = 16 MT tokens), up to NTO n8 output tiles
// a warp. Shared rows are padded (k32_stride) so the 16-byte fragment loads
// hit distinct banks.
template <int NW, int MT, int NTO>
__global__ void __launch_bounds__(NW * 32, 1) fused_ff_kernel(const Params p) {
  constexpr int BM = 16 * MT;
  constexpr int DK = 8 * NW;   // D columns per chunk
  constexpr int DKP = k32_stride(DK);
  const int cp = k32_stride(p.c);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sZ = reinterpret_cast<bf16*>(smem_raw);  // [BM][cp]
  bf16* sM = sZ + BM * cp;                       // [BM][DKP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;

  // 1. z = LN(x) (or x) for the token tile, one warp per row
  for (int r = warp; r < BM; r += NW) {
    const int row = m0 + r;
    bf16* zr = sZ + r * cp;
    const bf16* xr = p.x + (long long)row * p.c;
    if (row >= p.n) {
      for (int c = lane * 2; c < p.c; c += 64)
        *reinterpret_cast<uint32_t*>(zr + c) = 0u;
      continue;
    }
    if (p.lnw == nullptr) {
      for (int c = lane * 2; c < p.c; c += 64)
        *reinterpret_cast<uint32_t*>(zr + c) = ld32(xr + c);
      continue;
    }
    float s = 0.f, s2 = 0.f;
    for (int c = lane * 2; c < p.c; c += 64) {
      const float2 v = ld_bf162(xr + c);
      s += v.x + v.y;
      s2 += v.x * v.x + v.y * v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / p.c;
    const float var = fmaxf(s2 / p.c - mean * mean, 0.f);
    const float rstd = rsqrtf(var + p.eps);
    for (int c = lane * 2; c < p.c; c += 64) {
      const float2 v = ld_bf162(xr + c);
      *reinterpret_cast<uint32_t*>(zr + c) =
          pack_bf16((v.x - mean) * rstd * p.lnw[c] + p.lnb[c],
                    (v.y - mean) * rstd * p.lnw[c + 1] + p.lnb[c + 1]);
    }
  }
  __syncthreads();

  // output columns: warp w owns n8 tiles [w * tpw, (w + 1) * tpw)
  const int ntiles = p.cout / 8;
  const int tpw = (ntiles + NW - 1) / NW;
  const int tile0 = warp * tpw;
  float acc[MT][NTO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTO; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  for (int j0 = 0; j0 < p.d; j0 += DK) {
    // 2. this warp's n8 tiles of h and g over K = C, 32 deep a load
    float hacc[MT][4], gacc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[mt][e] = gacc[mt][e] = 0.f;
    const bf16* wh = p.w1 + (long long)(j0 + warp * 8 + g) * p.c + 8 * t;
    const bf16* wg = wh + (long long)p.d * p.c;
    uint4 bh = ldg128(wh), bg = ldg128(wg);
    for (int k = 0; k < p.c; k += 32) {
      uint4 nh = bh, ng = bg;
      if (k + 32 < p.c) {
        nh = ldg128(wh + k + 32);
        ng = ldg128(wg + k + 32);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[2][4];
        load_a_k32(a, sZ, cp, mt * 16, k, lane);
        mma_16816(hacc[mt], a[0], bh.x, bh.y);
        mma_16816(gacc[mt], a[0], bg.x, bg.y);
        mma_16816(hacc[mt], a[1], bh.z, bh.w);
        mma_16816(gacc[mt], a[1], bg.z, bg.w);
      }
      bh = nh;
      bg = ng;
    }
    // fp32 bias and gate; only m rounds to bf16 (m's columns are in their
    // natural order, which the out-GEMM's k32 loads of sM and W2 share)
    const int col = warp * 8 + 2 * t;
    const float bhv[2] = {__bfloat162float(p.b1[j0 + col]),
                          __bfloat162float(p.b1[j0 + col + 1])};
    const float bgv[2] = {__bfloat162float(p.b1[p.d + j0 + col]),
                          __bfloat162float(p.b1[p.d + j0 + col + 1])};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_lo = (hacc[mt][2 * r] + bhv[0]) *
                           gelu_exact(gacc[mt][2 * r] + bgv[0]);
        const float m_hi = (hacc[mt][2 * r + 1] + bhv[1]) *
                           gelu_exact(gacc[mt][2 * r + 1] + bgv[1]);
        *reinterpret_cast<uint32_t*>(sM + (mt * 16 + g + 8 * r) * DKP + col) =
            pack_bf16(m_lo, m_hi);
      }
    __syncthreads();

    // 3. acc += m W2[:, j0:j0+DK]^T over this warp's output tiles, five
    // tiles' 16-byte loads in flight at a time
#pragma unroll
    for (int kk = 0; kk < DK; kk += 32) {
      uint32_t a[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a_k32(a[mt], sM, DKP, mt * 16, kk, lane);
#pragma unroll
      for (int jg = 0; jg < NTO; jg += 5) {
        uint4 bw[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int tile = tile0 + jg + j;
          if (jg + j < NTO && jg + j < tpw && tile < ntiles)
            bw[j] = ldg128(p.w2 + (long long)(tile * 8 + g) * p.d + j0 + kk + 8 * t);
        }
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int tile = tile0 + jg + j;
          if (jg + j < NTO && jg + j < tpw && tile < ntiles) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16816(acc[mt][jg + j], a[mt][0], bw[j].x, bw[j].y);
              mma_16816(acc[mt][jg + j], a[mt][1], bw[j].z, bw[j].w);
            }
          }
        }
      }
    }
    __syncthreads();  // sM is consumed before the next chunk writes it
  }

  // epilogue: acc -> bf16, + b2, + x, each add rounded to bf16
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    const int tile = tile0 + j;
    if (j >= tpw || tile >= ntiles) continue;
    const int col = tile * 8 + 2 * t;
    const float c0 = __bfloat162float(p.b2[col]);
    const float c1 = __bfloat162float(p.b2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + mt * 16 + g + 8 * r;
        if (row >= p.n) continue;
        float y0 = round_bf16(round_bf16(acc[mt][j][2 * r]) + c0);
        float y1 = round_bf16(round_bf16(acc[mt][j][2 * r + 1]) + c1);
        if (p.residual) {
          const float2 xv = ld_bf162(p.x + (long long)row * p.c + col);
          y0 += xv.x;
          y1 += xv.y;
        }
        *reinterpret_cast<uint32_t*>(p.out + (long long)row * p.cout + col) =
            pack_bf16(y0, y1);
      }
  }
}

template <int NW, int MT, int NTO>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  const int smem =
      (BM * k32_stride(p.c) + BM * k32_stride(8 * NW)) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ff_kernel<NW, MT, NTO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + BM - 1) / BM);
  fused_ff_kernel<NW, MT, NTO><<<grid, NW * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, c), w1 (2d, c), b1 (2d), w2 (cout, d), b2 (cout), out (n, cout):
// contiguous bf16 (torch's Linear layout); lnw/lnb: fp32 (c)
// or both null. c % 32 == 0, cout % 8 == 0; cout <= 640 needs d % 64 == 0,
// cout <= 1280 d % 128 == 0. Returns a cudaError_t code (0 on success).
extern "C" int tc_fused_ff(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const float* lnw,
                           const float* lnb, void* out, int n, int c, int d,
                           int cout, float eps, int residual, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.lnw = lnw;
  p.lnb = lnb;
  p.out = static_cast<bf16*>(out);
  p.n = n;
  p.c = c;
  p.d = d;
  p.cout = cout;
  p.eps = eps;
  p.residual = residual;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || c % 32 || d % 32 || cout % 8 ||
      (residual && cout != c))
    return (int)cudaErrorInvalidValue;
  if (cout <= 8 * 8 * 5 && d % 64 == 0) return launch<8, 4, 5>(p, s);
  if (cout <= 8 * 8 * 10 && d % 64 == 0) return launch<8, 2, 10>(p, s);
  if (cout <= 16 * 8 * 10 && d % 128 == 0) return launch<16, 2, 10>(p, s);
  return (int)cudaErrorInvalidValue;
}
