// Temporal attention for Hopper (sm_90a): the self-attention sub-blocks of
// the UNet's temporal BasicTransformerBlock, one stage
//
//   y = x + to_out(attn_T(qkv(LN(x))))
//
// at a time, bf16 in and out. attn_T is softmax attention over the T frames
// of each pixel, per 64-wide head. Replaces
// tooncrafter_tpu/ops/temporal_attention.py::_fused_tpair_call (both
// stages, stage 1's output stage 2's input) and ::_fused_tattn_call (one
// stage).
//
// A stage is three kernels on one stream, split at z and at o, the tensors
// the TPU kernel itself rounds to bf16 (_attn_stage), so passing them
// through device memory in bf16 changes no number:
//   (a) z = LN(x)                 ln_and_out.cuh's ln_kernel (the FF's)
//   (b) o = attn_T(q, k, v)       qkv_kernel: the q|k|v GEMM with the
//                                 attention in its epilogue
//   (c) y = bf16(bf16(o Wo^T) + bo) + x   ln_and_out.cuh's out_kernel
// x, z and y are (B, T, P, C), the UNet's own layout (frames outer, pixels
// inner), o (B, T, P, inner) with inner = heads * 64: C for the whole
// block; under tensor parallelism a rank's share of the heads, whose
// q|k|v GEMM has N = 3 inner, whose out-GEMM has K = inner and takes
// ln_and_out.cuh's partial epilogue (the fp32 accumulator, no bias, no
// residual, no rounding: the sum over the ranks is finished by the caller).
// Stage 2's out-GEMM writes over stage 1's output in place (ln_and_out.cuh:
// each tile reads its residual before it stores it).
//
// (b) on the persistent mainloop of persistent_gemm.cuh (a TMA ring fed by a
// producer thread) in its cooperative mode: a tile is 128 tokens by one
// head's q | k | v (192 columns, K = C), each consumer warpgroup's 64-row
// half with the one B, so a K block read from L2 feeds 128 x 192 products
// (2 x 128 x 192 operations on 320 rows of 128 bytes: 77 a byte, against
// 48 for 64-row tiles in ping-pong, which were slower at C >= 512 and no
// faster at C = 320; PERF.md):
//   * A = z gathered pixel-major by a 4-D tensor map over z viewed as (C,
//     T, P, B) with boxes of {64 channels, T frames, 128 / T pixels, 1}:
//     row r of the tile is frame r % T of pixel r / T (T divides 16). Its
//     inner dimension stays 128 bytes, so the swizzle and the wgmma
//     descriptors are those of a 2-D box; pixels past P arrive as zeros;
//   * B = rows h 64.. of Wq, Wk and Wv (torch's Linear layout, three TMA
//     boxes making one 192-row operand, no concatenated copy); head tiles
//     run fastest, so the heads of one z tile read it from L2;
//   * the epilogue: warp w of the warpgroup holds rows 16 w .. 16 w + 15 of
//     the accumulator (whole pixels: 16 / T of them), so the attention is
//     warp-local, in registers, on mma.sync m16n8k16. q's accumulator
//     packed to bf16 is the A fragment of q k^T and k's is its B fragment;
//     the logits are fp32, x scale, -inf across pixels where T < 16; an
//     fp32 softmax over the keys; p rounded to bf16 is the A fragment of p
//     v; v's fragments reach p v's B layout by movmatrix.trans; o (fp32)
//     rounds to bf16 into the warpgroup's staging tile, which one thread
//     stores by TMA through a 4-D map of o in boxes of 64 / T pixels into
//     the head's 64 columns (rows past P are clipped). The attention is ~2
//     % of the products; the producer fills the ring for the next tile
//     while it runs.
//
// What bounds a stage on the H100: 8 N C^2 operations on 14 N C bytes
// (x and z; z and o; o, x and y), the bytes at C = 320 (~0.11 ms a stage at
// N = 81920) and the operations at C >= 640.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_and_out.cuh"
#include "mma_bf16.cuh"
#include "persistent_gemm.cuh"
#include "sm90.cuh"

namespace {
namespace tattn {

struct Tag;  // names this library's kernels in a trace
using pgemm::kBK;
constexpr int kD = 64;  // head width

// the 8x8 b16 matrix of a warp's fragments (lane l: row l / 4, columns
// 2 (l % 4), +1), transposed: lane l receives elements (2 (l % 4), l / 4)
// and (2 (l % 4) + 1, l / 4)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

struct QkvParams {
  int t;        // frames
  int heads;    // inner / 64
  int ppt;      // pixels a tile: 128 / T
  int ptiles;   // pixel tiles a sample: ceil(P / ppt)
  int kblocks;  // C / 64
  int tiles;    // B ptiles heads
  float scale;
};

// 128 rows x 192 accumulator columns (q, k, v of one head) a tile, 64 rows
// a warpgroup; the staging area holds a warpgroup's o (64 x 64, one
// 128-byte-swizzled box).
struct QkvOp {
  static constexpr int kBM = 128, kBN = 3 * kD;
  static constexpr bool kCoop = true;
  static constexpr int kStaging = 64 * kD * 2;
  static constexpr int kExtra = 0;
  QkvParams p;
  const CUtensorMap* tm_z;  // z as (C, T, P, B), boxes {64, T, ppt, 1}
  const CUtensorMap* tm_wq;
  const CUtensorMap* tm_wk;
  const CUtensorMap* tm_wv;
  const CUtensorMap* tm_o;  // o as (inner, T, P, B), boxes {64, T, ppt / 2,
                            // 1}

  // the tile's sample, first pixel and head
  struct Tile {
    int b, px0, h;
  };

  __device__ __forceinline__ Tile tile(int t) const {
    const int r = t / p.heads;
    return {r / p.ptiles, (r % p.ptiles) * p.ppt, t % p.heads};
  }
  __device__ __forceinline__ int tiles() const { return p.tiles; }
  __device__ __forceinline__ int kblocks() const { return p.kblocks; }

  // K block kb: channels kb 64.. of the tile's T frames x ppt pixels; rows
  // h 64.. of Wq, Wk and Wv
  __device__ __forceinline__ void load(void* a, void* b, uint64_t* bar,
                                       const Tile& c, int kb) const {
    unsigned char* sb = static_cast<unsigned char*>(b);
    const int k0 = kb * kBK, r0 = c.h * kD;
    sm90::tma_load_4d(a, tm_z, bar, k0, 0, c.px0, c.b);
    sm90::tma_load_2d(sb, tm_wq, bar, k0, r0);
    sm90::tma_load_2d(sb + kD * kBK * 2, tm_wk, bar, k0, r0);
    sm90::tma_load_2d(sb + 2 * kD * kBK * 2, tm_wv, bar, k0, r0);
  }

  __device__ __forceinline__ void before(const Tile&, unsigned char*,
                                         unsigned char*, uint64_t*) const {}

  // The attention of the warp's 16 rows, with the TPU kernel's rounding.
  // Thread (g = lane / 4, t4 = lane % 4) holds acc[4 j + e] at row g + 8 (e
  // / 2) of the warp's, column 8 j + 2 t4 + (e % 2): q in j 0-7, k in 8-15,
  // v in 16-23.
  __device__ __forceinline__ void epilogue(float (&acc)[1][kBN / 2],
                                           const Tile& c, int, int wgi,
                                           unsigned char* stage,
                                           unsigned char*, uint64_t*) const {
    const float(&a)[kBN / 2] = acc[0];
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2, t4 = lane & 3;
    // logits = q k^T (16 queries x 16 keys, K = 64 in four k16 steps): q's
    // registers are the A fragment, k's (keys as rows) the B fragment
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t qa[4] = {
          pack_bf16(a[8 * kk], a[8 * kk + 1]),
          pack_bf16(a[8 * kk + 2], a[8 * kk + 3]),
          pack_bf16(a[8 * kk + 4], a[8 * kk + 5]),
          pack_bf16(a[8 * kk + 6], a[8 * kk + 7])};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)  // keys 8 nt .. 8 nt + 7
        mma_16816(s[nt], qa,
                  pack_bf16(a[32 + 8 * kk + 2 * nt], a[33 + 8 * kk + 2 * nt]),
                  pack_bf16(a[36 + 8 * kk + 2 * nt], a[37 + 8 * kk + 2 * nt]));
    }
    // fp32 softmax over the keys of each query's pixel; pr[4 nt + e] is the
    // probability of s[nt][e], in p v's A-fragment order
    float pr[8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = g + 8 * hr;  // the query's row among the warp's 16
      float l[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * nt + 2 * t4 + e;
          l[2 * nt + e] = qi / p.t == key / p.t
                              ? s[nt][2 * hr + e] * p.scale : -INFINITY;
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
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          pr[4 * nt + 2 * hr + e] = ex[2 * nt + e] / den;
    }
    const uint32_t pa[4] = {pack_bf16(pr[0], pr[1]), pack_bf16(pr[2], pr[3]),
                            pack_bf16(pr[4], pr[5]), pack_bf16(pr[6], pr[7])};
    // o = p v, eight n8 tiles of d, each rounded into the staging tile (16-
    // byte chunk c of row r at chunk c ^ (r % 8): conflict-free)
    pgemm::epi_wait_staging(wgi);
    unsigned char* srow = stage + (16 * warp + g) * 128 + 4 * t4;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t b0 =
          movmatrix_trans(pack_bf16(a[64 + 4 * nt], a[65 + 4 * nt]));
      const uint32_t b1 =
          movmatrix_trans(pack_bf16(a[66 + 4 * nt], a[67 + 4 * nt]));
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      mma_16816(o, pa, b0, b1);
      unsigned char* px = srow + ((nt ^ g) << 4);
      *reinterpret_cast<uint32_t*>(px) = pack_bf16(o[0], o[1]);
      *reinterpret_cast<uint32_t*>(px + 8 * 128) = pack_bf16(o[2], o[3]);
    }
    pgemm::epi_publish(wgi);
    if ((threadIdx.x & 127) == 0) {
      sm90::tma_store_4d(tm_o, stage, c.h * kD, 0,
                         c.px0 + wgi * (p.ppt / 2), c.b);
      sm90::bulk_commit();
    }
  }
};

__global__ void __launch_bounds__(pgemm::kThreads, 1)
qkv_kernel(const QkvParams p, const __grid_constant__ CUtensorMap tm_z,
           const __grid_constant__ CUtensorMap tm_wq,
           const __grid_constant__ CUtensorMap tm_wk,
           const __grid_constant__ CUtensorMap tm_wv,
           const __grid_constant__ CUtensorMap tm_o) {
  extern __shared__ unsigned char smem_raw[];
  const QkvOp op{p, &tm_z, &tm_wq, &tm_wk, &tm_wv, &tm_o};
  pgemm::run(op, smem_raw);
}

// a (B, T, P, C) bf16 tensor viewed as (C, T, P, B), in boxes of {64, T,
// rows / T, 1}
int make_map_tokens(CUtensorMap* map, const void* base, int b, int t, int p,
                    int c, int rows) {
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)t, (uint64_t)p,
                            (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)p * c * 2, (uint64_t)c * 2,
                               (uint64_t)t * p * c * 2};
  const uint32_t box[4] = {(uint32_t)kBK, (uint32_t)t, (uint32_t)(rows / t),
                           1u};
  return sm90_host::make_map(map, base, 4, dims, strides, box);
}

// z (b, t, p, c); wq, wk, wv (inner, c); o (b, t, p, inner)
int launch_qkv(const void* z, const void* wq, const void* wk, const void* wv,
               void* o, int b, int t, int p, int c, int inner, float scale,
               int grid, cudaStream_t stream) {
  using R = pgemm::RingOf<QkvOp>;
  QkvParams q{};
  q.t = t;
  q.heads = inner / kD;
  q.ppt = QkvOp::kBM / t;
  q.ptiles = (p + q.ppt - 1) / q.ppt;
  q.kblocks = c / kBK;
  q.tiles = b * q.ptiles * q.heads;
  q.scale = scale;
  if (grid < 1 || grid > q.tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap tz, tq, tk, tv, to;
  int err = make_map_tokens(&tz, z, b, t, p, c, QkvOp::kBM);
  if (!err) err = lnout::make_map(&tq, wq, c, inner, kD);
  if (!err) err = lnout::make_map(&tk, wk, c, inner, kD);
  if (!err) err = lnout::make_map(&tv, wv, c, inner, kD);
  if (!err) err = make_map_tokens(&to, o, b, t, p, inner, 64);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return (int)e;
  qkv_kernel<<<grid, pgemm::kThreads, R::kBytes, stream>>>(q, tz, tq, tk, tv,
                                                           to);
  return (int)cudaGetLastError();
}

// the tiles of (b) and (c), chosen by the wrapper
struct Tiles {
  int qkv_grid;               // (b)'s persistent blocks
  int out_bm, out_bn, out_grid;  // (c)'s tile and blocks
};

// one stage: x -> out through the scratch z and o; w = {wq, wk, wv, wo, bo};
// partial: out is the fp32 accumulator (bo unused)
int run_stage(const void* x, const float* lnw, const float* lnb,
              const void* const (&w)[5], void* z, void* o, void* out, int b,
              int t, int p, int c, int inner, bool partial, float scale,
              float eps, const Tiles& tl, cudaStream_t s) {
  const int n = b * t * p;
  int err = lnout::launch_ln<Tag>(x, lnw, lnb, z, n, c, eps, s);
  if (!err)
    err = launch_qkv(z, w[0], w[1], w[2], o, b, t, p, c, inner, scale,
                     tl.qkv_grid, s);
  if (err) return err;
  if (partial)
    return lnout::launch_out_partial<Tag>(o, w[3], static_cast<float*>(out),
                                          n, inner, c, tl.out_bm, tl.out_bn,
                                          tl.out_grid, s);
  return lnout::launch_out<Tag>(o, w[3], w[4], x, out, n, inner, c,
                                tl.out_bm, tl.out_bn, tl.out_grid, s);
}

bool valid(int b, int t, int p, int c, int inner) {
  return b > 0 && p > 0 && t > 0 && 16 % t == 0 && c > 0 && c % kD == 0 &&
         inner > 0 && inner % kD == 0 && b <= 65535 &&
         (long long)b * t * p < (1ll << 31);
}

}  // namespace tattn
}  // namespace

// x, out (b, t, p, c) contiguous bf16; per stage: lnw, lnb fp32 (c); wq, wk,
// wv, wo (c, c) and bo (c) bf16, torch's Linear layout. Scratch from the
// caller: z and o (b, t, p, c) bf16. c = heads * 64; t divides 16. The
// tiles: the q|k|v GEMM's qkv_grid persistent blocks (at most B ceil(P /
// (128 / T)) heads), the out-GEMM's out_bm (64 or 128) x out_bn (128 or 160)
// tiles on out_grid blocks. Stage 2 runs on out in place. Returns a
// cudaError_t code (0 on success).
extern "C" int tc_temporal_attn_pair(
    const void* x, const float* ln1w, const float* ln1b, const void* wq1,
    const void* wk1, const void* wv1, const void* wo1, const void* bo1,
    const float* ln2w, const float* ln2b, const void* wq2, const void* wk2,
    const void* wv2, const void* wo2, const void* bo2, void* z, void* o,
    void* out, int b, int t, int p, int c, float scale, float eps,
    int qkv_grid, int out_bm, int out_bn, int out_grid, void* stream) {
  using namespace tattn;
  if (!valid(b, t, p, c, c)) return (int)cudaErrorInvalidValue;
  const Tiles tl{qkv_grid, out_bm, out_bn, out_grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const w1[5] = {wq1, wk1, wv1, wo1, bo1};
  const void* const w2[5] = {wq2, wk2, wv2, wo2, bo2};
  const int err = run_stage(x, ln1w, ln1b, w1, z, o, out, b, t, p, c, c,
                            false, scale, eps, tl, s);
  if (err) return err;
  return run_stage(out, ln2w, ln2b, w2, z, o, out, b, t, p, c, c, false,
                   scale, eps, tl, s);
}

// One sub-block, y = x + to_out(attn_T(qkv(LN(x)))), with the pair's
// limits, layouts and tiles, at inner = heads * 64 (wq, wk, wv (inner, c),
// wo (c, inner), o (b, t, p, inner)). partial: out (b, t, p, c) is the
// out-GEMM's fp32 accumulator, bo unused.
extern "C" int tc_temporal_attn_single(
    const void* x, const float* lnw, const float* lnb, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bo, void* z,
    void* o, void* out, int b, int t, int p, int c, int inner, int partial,
    float scale, float eps, int qkv_grid, int out_bm, int out_bn,
    int out_grid, void* stream) {
  using namespace tattn;
  if (!valid(b, t, p, c, inner)) return (int)cudaErrorInvalidValue;
  const Tiles tl{qkv_grid, out_bm, out_bn, out_grid};
  const void* const w[5] = {wq, wk, wv, wo, bo};
  return run_stage(x, lnw, lnb, w, z, o, out, b, t, p, c, inner,
                   partial != 0, scale, eps, tl,
                   static_cast<cudaStream_t>(stream));
}
