// Temporal attention pair for Hopper (sm_90a): both self-attention
// sub-blocks of the UNet's temporal BasicTransformerBlock in one kernel,
//
//   y   = x + to_out1(attn_T(qkv1(LN1(x))))
//   out = y + to_out2(attn_T(qkv2(LN2(y))))
//
// attn_T is softmax attention over the T frames of each pixel, per 64-wide
// head. Replaces tooncrafter_tpu/ops/temporal_attention.py::_fused_tpair_call
// and, run for one stage (NS = 1), its single sub-block kernel
// _fused_tattn_call.
//
// Layout. x and out are (B, T, P, C) bf16, the UNet's own layout (frames
// outer, pixels inner): the kernel gathers each pixel's T frames by stride,
// so the (B, P, T, C) transposes around the TPU kernel do not exist here. A
// block takes BM = 16 MT tokens, BM / T whole pixels (T divides 16): row r
// of the tile is frame r % T of pixel r / T, so each m16 row tile holds
// 16 / T whole pixels and a pixel's attention never leaves its m16 tile.
//
// Per stage, with the TPU kernel's rounding (_attn_stage):
//   1. z = LN(input): fp32 statistics, E[x^2] - mean^2 clamped at 0, rounded
//      to bf16 into shared memory;
//   2. per head h (64 of the C = heads * 64 columns):
//      a. q, k, v = z W{q,k,v}[h]^T, fp32 accumulators rounded to bf16 into
//         shared memory (warp w computes columns 8w..8w+7 of each);
//      b. per m16 tile: logits = (q k^T) * scale in fp32, -inf outside the
//         pixel where T < 16, fp32 softmax (max, exp, sum, divide), the
//         probabilities rounded to bf16 as the A fragment of p v, whose fp32
//         result rounds to bf16 into o[:, h] in shared memory. A tile's
//         warps split o's eight n8 column tiles; each recomputes the
//         16 x 16 logits (8 products);
//   3. out-projection, y = o Wout^T over K = C, in column chunks of 8 NTW
//      n8 tiles (NTW a warp, interleaved), fp32 registers per chunk; then
//      bf16(bf16(y) + bout) + input, rounded to bf16. Stage 1's result goes
//      to shared memory as stage 2's LayerNorm input (over z, which is dead
//      by then) and to device memory as stage 2's residual (each thread
//      reads back only what it wrote); stage 2's is the output.
// Step b is ~2 % of the products: 2 x 16 x 16 x 64 per pixel and head,
// against 16 x 4 C x 64 for the projections of its 16 tokens.
//
// Weights keep torch's Linear layout (out, in) and are read from L2 by
// 16-byte loads in the k32 order of mma_bf16.cuh (no permuted copy). Every
// token tile reads all of a pair's weights (16 C^2 bytes) from L2, so the
// tile should be as large as shared memory allows: z and o (BM x C bf16
// each) set it, 64 tokens at C <= 640 and 32 at C = 1280 (~180-200 KB).
// Keeping o in shared memory frees the tile from the output accumulator:
// accumulating the out-projection head by head in registers (BM x C fp32
// over the block's 8 warps) would cap it at 16 tokens at C = 1280.
//
// A first version: mma.sync m16n8k16, one block of 8 warps per token tile;
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;                     // head width
constexpr int kNW = 8;                     // warps a block
constexpr int kQP = k32_stride(3 * kD);    // shared row of q | k | v

struct Stage {
  const float* lnw;  // (c) fp32
  const float* lnb;
  const bf16* wq;    // (c, c), torch's Linear layout (out, in)
  const bf16* wk;
  const bf16* wv;
  const bf16* wo;    // (c, c)
  const bf16* bo;    // (c)
};

struct Params {
  const bf16* x;     // (b, t, p, c)
  bf16* out;         // (b, t, p, c)
  Stage st[2];
  int b, t, p, c;
  float scale, eps;
};

__device__ __forceinline__ uint4 ldg128(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// NS = 2: the pair (tc_temporal_attn_pair); NS = 1: one sub-block, the single-
// stage kernel tooncrafter_tpu/ops/temporal_attention.py::_fused_tattn_call
// (tc_temporal_attn_single), whose st[0] is the stage
template <int MT, int NTW, int NS>
__global__ void __launch_bounds__(kNW * 32, 1) tpair_kernel(const Params p) {
  constexpr int BM = 16 * MT;
  constexpr int WPM = kNW / MT;  // warps per m16 tile in step b
  constexpr int NPV = 8 / WPM;   // n8 tiles of o per warp in step b
  const int cp = k32_stride(p.c);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sZ = reinterpret_cast<bf16*>(smem_raw);  // [BM][cp] z, then stage 1's output
  bf16* sO = sZ + BM * cp;                       // [BM][cp] o of every head
  bf16* sQKV = sO + BM * cp;                     // [BM][kQP] one head's q | k | v

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ppt = BM / p.t;  // pixels a tile
  const int tiles_p = (p.p + ppt - 1) / ppt;
  const int bi = blockIdx.x / tiles_p;
  const int p0 = (blockIdx.x % tiles_p) * ppt;
  // token row r of the tile -> its row of x / out, or -1 past the last pixel
  auto grow = [&](int r) -> long long {
    const int px = p0 + r / p.t;
    return px < p.p ? ((long long)bi * p.t + r % p.t) * p.p + px : -1;
  };
  const int ntiles = p.c / 8;
  const int heads = p.c / kD;

  for (int s = 0; s < NS; ++s) {
    const Stage st = s == 0 ? p.st[0] : p.st[1];

    // 1. z = LN(input) for the token tile, one warp per row (stage 2 reads
    // its input from sZ and overwrites it in place, row by row)
    for (int r = warp; r < BM; r += kNW) {
      bf16* zr = sZ + r * cp;
      const long long row = grow(r);
      if (s == 0 && row < 0) {
        for (int c = lane * 2; c < p.c; c += 64)
          *reinterpret_cast<uint32_t*>(zr + c) = 0u;
        continue;
      }
      const bf16* xr = s == 0 ? p.x + row * p.c : zr;
      float sum = 0.f, sq = 0.f;
      for (int c = lane * 2; c < p.c; c += 64) {
        const float2 v = ld_bf162(xr + c);
        sum += v.x + v.y;
        sq += v.x * v.x + v.y * v.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      const float mean = sum / p.c;
      const float rstd = rsqrtf(fmaxf(sq / p.c - mean * mean, 0.f) + p.eps);
      for (int c = lane * 2; c < p.c; c += 64) {
        const float2 v = ld_bf162(xr + c);
        *reinterpret_cast<uint32_t*>(zr + c) =
            pack_bf16((v.x - mean) * rstd * st.lnw[c] + st.lnb[c],
                      (v.y - mean) * rstd * st.lnw[c + 1] + st.lnb[c + 1]);
      }
    }
    __syncthreads();

    for (int h = 0; h < heads; ++h) {
      // a. columns 8 warp .. 8 warp + 7 of this head's q, k and v, K = C
      {
        float qa[MT][3][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            qa[mt][j][0] = qa[mt][j][1] = qa[mt][j][2] = qa[mt][j][3] = 0.f;
        const long long wrow = (long long)(h * kD + warp * 8 + g) * p.c + 8 * t4;
        const bf16* wp[3] = {st.wq + wrow, st.wk + wrow, st.wv + wrow};
        uint4 bw[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) bw[j] = ldg128(wp[j]);
        for (int k = 0; k < p.c; k += 32) {
          uint4 nb[3];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            nb[j] = k + 32 < p.c ? ldg128(wp[j] + k + 32) : bw[j];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[2][4];
            load_a_k32(a, sZ, cp, mt * 16, k, lane);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              mma_16816(qa[mt][j], a[0], bw[j].x, bw[j].y);
              mma_16816(qa[mt][j], a[1], bw[j].z, bw[j].w);
            }
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) bw[j] = nb[j];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              *reinterpret_cast<uint32_t*>(
                  sQKV + (mt * 16 + g + 8 * hr) * kQP + j * kD + warp * 8 +
                  2 * t4) = pack_bf16(qa[mt][j][2 * hr], qa[mt][j][2 * hr + 1]);
      }
      __syncthreads();

      // b. attention over the frames of each pixel of m16 tile mt -> o[:, h]
      {
        const int r0 = (warp / WPM) * 16;
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kD; kk += 32) {
          uint32_t a[2][4];
          load_a_k32(a, sQKV, kQP, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint4 kb = lds128(sQKV + (r0 + 8 * j + g) * kQP + kD + kk + 8 * t4);
            mma_16816(sc[j], a[0], kb.x, kb.y);
            mma_16816(sc[j], a[1], kb.z, kb.w);
          }
        }
        float pr[2][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // query row g + 8 hr of the tile
          const int qrow = g + 8 * hr;
          float l[4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j + 2 * t4 + e;
              l[2 * j + e] = qrow / p.t == key / p.t
                                 ? sc[j][2 * hr + e] * p.scale : -INFINITY;
            }
          float m = fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          float ex[4], den = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ex[i] = expf(l[i] - m);
            den += ex[i];
          }
          den += __shfl_xor_sync(0xffffffffu, den, 1);
          den += __shfl_xor_sync(0xffffffffu, den, 2);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) pr[j][2 * hr + e] = ex[2 * j + e] / den;
        }
        // the logits' C fragments are p's A fragment (keys as k)
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]),
                                pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]),
                                pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
        for (int i = 0; i < NPV; ++i) {
          const int nt = (warp % WPM) * NPV + i;
          uint32_t vb[2];
          ldmatrix_x2_trans(vb, sQKV + (r0 + (lane & 15)) * kQP + 2 * kD + nt * 8);
          float o[4] = {0.f, 0.f, 0.f, 0.f};
          mma_16816(o, pa, vb[0], vb[1]);
          bf16* orow = sO + (r0 + g) * cp + h * kD + nt * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(orow) = pack_bf16(o[0], o[1]);
          *reinterpret_cast<uint32_t*>(orow + 8 * cp) = pack_bf16(o[2], o[3]);
        }
      }
      __syncthreads();  // sQKV is free for the next head; o[:, h] is whole
    }

    // 3. y = o Wout^T in column chunks: warp w owns n8 tiles base + j kNW
    for (int base = warp; base < ntiles + warp; base += kNW * NTW) {
      float acc[MT][NTW][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
      for (int k = 0; k < p.c; k += 32) {
        uint32_t a[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_a_k32(a[mt], sO, cp, mt * 16, k, lane);
#pragma unroll
        for (int jg = 0; jg < NTW; jg += 5) {
          uint4 bw[5];
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const int tile = base + (jg + j) * kNW;
            if (jg + j < NTW && tile < ntiles)
              bw[j] = ldg128(st.wo + (long long)(tile * 8 + g) * p.c + k + 8 * t4);
          }
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const int tile = base + (jg + j) * kNW;
            if (jg + j < NTW && tile < ntiles) {
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_16816(acc[mt][jg + j], a[mt][0], bw[j].x, bw[j].y);
                mma_16816(acc[mt][jg + j], a[mt][1], bw[j].z, bw[j].w);
              }
            }
          }
        }
      }
      // epilogue: y -> bf16, + bout, + input, each add rounded to bf16
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int tile = base + j * kNW;
        if (tile >= ntiles) continue;
        const int col = tile * 8 + 2 * t4;
        const float c0 = __bfloat162float(st.bo[col]);
        const float c1 = __bfloat162float(st.bo[col + 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mt * 16 + g + 8 * hr;
            const long long row = grow(r);
            float y0 = round_bf16(round_bf16(acc[mt][j][2 * hr]) + c0);
            float y1 = round_bf16(round_bf16(acc[mt][j][2 * hr + 1]) + c1);
            if (row >= 0) {  // stage 1: + x; stage 2: + stage 1's output
              const float2 xv = ld_bf162((s == 0 ? p.x : p.out) + row * p.c + col);
              y0 += xv.x;
              y1 += xv.y;
              *reinterpret_cast<uint32_t*>(p.out + row * p.c + col) =
                  pack_bf16(y0, y1);
            }
            if (s + 1 < NS)
              *reinterpret_cast<uint32_t*>(sZ + r * cp + col) = pack_bf16(y0, y1);
          }
      }
    }
    __syncthreads();  // stage 1's output is whole in sZ before stage 2's LN
  }
}

template <int MT, int NTW, int NS>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  const int smem = (2 * BM * k32_stride(p.c) + BM * kQP) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      tpair_kernel<MT, NTW, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int ppt = BM / p.t;
  const long long blocks = (long long)p.b * ((p.p + ppt - 1) / ppt);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tpair_kernel<MT, NTW, NS><<<(unsigned)blocks, kNW * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (b, t, p, c) contiguous bf16; per stage: lnw, lnb fp32 (c); wq, wk,
// wv, wo (c, c) and bo (c) bf16, torch's Linear layout. c = heads * 64,
// c <= 1280; t divides 16. Returns a cudaError_t code (0 on success).
extern "C" int tc_temporal_attn_pair(
    const void* x, const float* ln1w, const float* ln1b, const void* wq1,
    const void* wk1, const void* wv1, const void* wo1, const void* bo1,
    const float* ln2w, const float* ln2b, const void* wq2, const void* wk2,
    const void* wv2, const void* wo2, const void* bo2, void* out, int b, int t,
    int p, int c, float scale, float eps, void* stream) {
  if (b <= 0 || p <= 0 || t <= 0 || 16 % t || c <= 0 || c % kD || c > 1280)
    return (int)cudaErrorInvalidValue;
  Params q;
  q.x = static_cast<const bf16*>(x);
  q.out = static_cast<bf16*>(out);
  q.st[0] = {ln1w, ln1b, static_cast<const bf16*>(wq1),
             static_cast<const bf16*>(wk1), static_cast<const bf16*>(wv1),
             static_cast<const bf16*>(wo1), static_cast<const bf16*>(bo1)};
  q.st[1] = {ln2w, ln2b, static_cast<const bf16*>(wq2),
             static_cast<const bf16*>(wk2), static_cast<const bf16*>(wv2),
             static_cast<const bf16*>(wo2), static_cast<const bf16*>(bo2)};
  q.b = b;
  q.t = t;
  q.p = p;
  q.c = c;
  q.scale = scale;
  q.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64 tokens a tile where z and o fit in shared memory beside one head's
  // q | k | v, else 32; the out-projection's chunk keeps 80 accumulators a
  // thread
  if (c <= 640) return launch<4, 5, 2>(q, s);
  return launch<2, 10, 2>(q, s);
}

// One sub-block, y = x + to_out(attn_T(qkv(LN(x)))), with the pair's limits
// and layouts.
extern "C" int tc_temporal_attn_single(
    const void* x, const float* lnw, const float* lnb, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bo, void* out,
    int b, int t, int p, int c, float scale, float eps, void* stream) {
  if (b <= 0 || p <= 0 || t <= 0 || 16 % t || c <= 0 || c % kD || c > 1280)
    return (int)cudaErrorInvalidValue;
  Params q;
  q.x = static_cast<const bf16*>(x);
  q.out = static_cast<bf16*>(out);
  q.st[0] = {lnw, lnb, static_cast<const bf16*>(wq),
             static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
             static_cast<const bf16*>(wo), static_cast<const bf16*>(bo)};
  q.st[1] = q.st[0];
  q.b = b;
  q.t = t;
  q.p = p;
  q.c = c;
  q.scale = scale;
  q.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 640) return launch<4, 5, 1>(q, s);
  return launch<2, 10, 1>(q, s);
}
