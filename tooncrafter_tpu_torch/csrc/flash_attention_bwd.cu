// Flash-attention backward for Hopper (sm_90a), d = 64, bf16 operands,
// fp32 accumulation.
//
// Replaces the TPU kernel tooncrafter_tpu/ops/flash_attention.py::
// _flash_bwd_bh (its two pallas_calls, dq over query tiles and dk/dv over
// key tiles). With the forward's lse, p = exp(scale q k^T - lse) is
// recomputed tile by tile, D = rowsum(dO * O), and
//   dv = p^T dO,   ds = p * (dO v^T - D),   dq = scale ds k,
//   dk = scale ds^T q,
// p and ds rounded to bf16 before their products, as the TPU kernel does.
// q, k, v, O, dO and the three gradients are read and written at the
// caller's element strides (batch, sequence, head), so the packed
// (B, S, 3C) projection and its gradient are used in place.
//
// What bounds it on the H100: five 64-deep products per (query, key) pair
// (S, dP, dV, dK, dQ) on the tensor cores, an exp2 per score on the FP32
// units, and dq, which every key tile adds to. Three launches, in order on
// the caller's stream:
//   * flash_bwd_prep: D for every query row and lse * log2(e), both into
//     (batch * heads, sq_pad) scratch padded to whole 64-row tiles (+inf
//     and 0 past sq, so padded rows give p = 0), and clears the fp32 dq
//     accumulator (batch * heads, sq_pad, 64);
//   * flash_bwd_kernel: one block per 128 keys of one (batch, head), one
//     pass over the query tiles with the five products on wgmma. Two
//     consumer warpgroups own 64 keys each and keep their dk and dv in
//     registers; a producer thread brings Q, dO (TMA, 128-byte swizzle),
//     lse and D (bulk copies) of each 64-row query tile into a 3-stage ring.
//     Each warpgroup computes S^T = K Q^T and dP^T = V dO^T (64 keys x 64
//     queries, operands in shared memory), p^T and ds^T in registers, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A operands
//     (the accumulators are already in A-fragment order; dO and Q read
//     through wgmma's transpose of B). Both store their bf16 dS^T rows into
//     a shared 128-key x 64-query tile, and warpgroup 0 computes dQ = dS K
//     from it (A and B both MN-major, the transpose flags), 128 keys deep;
//     its fp32 tile goes through shared memory to one bulk reduce-add
//     (cp.reduce.async.bulk) into the accumulator: fp32 additions in L2 in
//     the order the blocks arrive, so dq is not bit-reproducible from run
//     to run (dk and dv are);
//   * flash_bwd_post: dq = bf16(scale * accumulator) at the caller's
//     strides.
// The accumulator holds each tile's 64 x 64 values in the order of
// warpgroup 0's fragments (pair k of thread i at float 2 (128 k + i)), so
// the staging writes are conflict-free 8-byte rows; the post-pass reads
// them back in that order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;          // head dim
constexpr int kBM = 64;         // query rows a tile of the loop
constexpr int kBN = 128;        // keys a block: 64 per consumer warpgroup
constexpr int kStages = 3;      // the query-tile ring
constexpr int kThreads = 3 * 128;
constexpr int kQTile = kBM * kD * 2;  // bytes of a Q or dO tile
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (batch * heads, sq), natural log
  float* dsum;       // (batch * heads, sq_pad): D
  float* lse2;       // (batch * heads, sq_pad): lse * log2(e)
  float* dq_acc;     // (batch * heads, sq_pad, 64), fragment order
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int heads, sq, sk, sq_pad;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, ex2.approx (ftz)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// the pre-pass: D, lse * log2(e), a cleared dq accumulator
// ---------------------------------------------------------------------------

// block (query tile, batch * head), 512 threads: 8 a row, 16 bytes each
__global__ void __launch_bounds__(512) flash_bwd_prep(const BwdParams p) {
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int row = blockIdx.x * kBM + tid / 8;
  const int c = (tid % 8) * 8;
  float acc = 0.f;
  if (row < p.sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        p.dout + b * p.do_sb + h * p.do_sh + (long long)row * p.do_ss + c);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(x[i]);
      const float2 d = __bfloat1622float2(y[i]);
      acc += a.x * d.x + a.y * d.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  const long long at = (long long)bh * p.sq_pad + row;
  if (tid % 8 == 0) {
    p.dsum[at] = acc;
    p.lse2[at] = row < p.sq ? p.lse[(long long)bh * p.sq + row] * kLog2e
                            : pos_inf();
  }
  float4* z = reinterpret_cast<float4*>(p.dq_acc + at * kD + c);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// the main pass
// ---------------------------------------------------------------------------

struct Smem {  // 1024-byte aligned; operand tiles in 128-byte-swizzled rows
  bf16 k[kBN * kD];             // [key][64]
  bf16 v[kBN * kD];
  bf16 q[kStages][kBM * kD];    // [query][64]
  bf16 dout[kStages][kBM * kD];
  bf16 ds[2][kBN * kBM];        // dS^T: [key][query]
  float dq[2][kBM * kD];        // warpgroup 0's dq tile, fragment order
  float lse2[kStages][kBM];
  float dsum[kStages][kBM];
  uint64_t kv_full;
  uint64_t full[kStages], empty[kStages];
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;

// named barriers (0 is __syncthreads): dS tile b written by both
// warpgroups (kDsFull + b), dS tile b read by warpgroup 0's dQ (kDsFree +
// b), warpgroup 0 alone (kWg0)
constexpr int kDsFull = 1, kDsFree = 3, kWg0 = 5;

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int n0 = blockIdx.x * kBN;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n_tiles = (p.sq + kBM - 1) / kBM;

  if (tid == 0) {
    sm90::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 8);  // one per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      sm90::mbar_expect_tx(&sm.kv_full, 2 * kBN * kD * 2);
      sm90::tma_load_4d(sm.k, &tm_k, &sm.kv_full, 0, h, n0, b);
      sm90::tma_load_4d(sm.v, &tm_v, &sm.kv_full, 0, h, n0, b);
      const long long row0 = (long long)bh * p.sq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.full[s], 2 * kQTile + 2 * kBM * 4);
        sm90::tma_load_4d(sm.q[s], &tm_q, &sm.full[s], 0, h, it * kBM, b);
        sm90::tma_load_4d(sm.dout[s], &tm_do, &sm.full[s], 0, h, it * kBM,
                          b);
        sm90::bulk_load(sm.lse2[s], p.lse2 + row0 + it * kBM, kBM * 4,
                        &sm.full[s]);
        sm90::bulk_load(sm.dsum[s], p.dsum + row0 + it * kBM, kBM * 4,
                        &sm.full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int tw = tid & 127;
  // this thread's key rows of the block: kr, kr + 8
  const int kr = wgi * 64 + warp * 16 + g;
  const float sl2 = p.scale_log2;
  const bool ragged = n0 + kBN > p.sk;
  // K and V rows of this warpgroup's keys: the A of S^T and dP^T
  const uint64_t desc_k = sm90::desc_sw128(sm.k + wgi * 64 * kD);
  const uint64_t desc_v = sm90::desc_sw128(sm.v + wgi * 64 * kD);

  float dv_acc[32], dk_acc[32], dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv_acc[i] = dk_acc[i] = dq_acc[i] = 0.f;
  float s_acc[32], dp_acc[32];  // S^T, then p^T; dP^T, then ds^T
  uint32_t pa[4][4], da[4][4];  // p^T and ds^T as bf16 A fragments

  // S^T = K Q^T and dP^T = V dO^T of query tile `it`: 64 keys x 64
  // queries, K-major
  auto issue_sdp = [&](int it) {
    const int s = it % kStages;
    sm90::mbar_wait(&sm.full[s], (it / kStages) & 1);
    const uint64_t desc_q = sm90::desc_sw128(sm.q[s]);
    const uint64_t desc_do = sm90::desc_sw128(sm.dout[s]);
    sm90::fence_regs(s_acc);
    sm90::fence_regs(dp_acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::wgmma_m64n64k16_ss<0, 0>(s_acc, sm90::desc_add(desc_k, 32 * kk),
                                     sm90::desc_add(desc_q, 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::wgmma_m64n64k16_ss<0, 0>(dp_acc, sm90::desc_add(desc_v, 32 * kk),
                                     sm90::desc_add(desc_do, 32 * kk),
                                     kk > 0);
    sm90::wgmma_commit();
  };

  sm90::mbar_wait(&sm.kv_full, 0);
  issue_sdp(0);
  sm90::wgmma_wait<0>();
  // tile it + 1's S^T and dP^T run on the tensor cores behind tile it's
  // dV, dK (and dQ)
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int buf = it & 1;
    const uint64_t desc_q = sm90::desc_sw128(sm.q[s]);
    const uint64_t desc_do = sm90::desc_sw128(sm.dout[s]);
    sm90::fence_regs(s_acc);
    sm90::fence_regs(dp_acc);

    // p^T and ds^T: element [4j + e] is key kr + 8 (e / 2), query
    // 8j + 2t + (e % 2) of the tile; keys past sk give p = 0
    bool key_ok[2] = {true, true};
    if (ragged) {
      key_ok[0] = n0 + kr < p.sk;
      key_ok[1] = n0 + kr + 8 < p.sk;
    }
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(&sm.lse2[s][8 * j + 2 * t]);
      const float2 dd =
          *reinterpret_cast<const float2*>(&sm.dsum[s][8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv =
            key_ok[e >> 1]
                ? ex2(fmaf(s_acc[4 * j + e], sl2, (e & 1) ? -l2.y : -l2.x))
                : 0.f;
        s_acc[4 * j + e] = pv;
        dp_acc[4 * j + e] = pv * (dp_acc[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s_acc[8 * kk + 2 * i], s_acc[8 * kk + 2 * i + 1]);
        da[kk][i] =
            pack_bf16(dp_acc[8 * kk + 2 * i], dp_acc[8 * kk + 2 * i + 1]);
      }

    // this warpgroup's rows of the shared dS^T tile (row = key, 64
    // queries); warpgroup 1 first waits for warpgroup 0's dQ two tiles
    // back to be done with the buffer
    if (wgi == 1 && it >= 2) sm90::bar_sync(kDsFree + buf, 256);
    uint32_t* dst = reinterpret_cast<uint32_t*>(sm.ds[buf]);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kr + 8 * r;
        dst[row * 32 + ((j ^ (row & 7)) << 2) + t] =
            da[j >> 1][(j & 1) * 2 + r];
      }
    sm90::fence_async_smem();
    if (wgi == 1) sm90::bar_arrive(kDsFull + buf, 256);

    // dV += P^T dO and dK += dS^T Q: the queries are the reduction axis,
    // dO and Q read MN-major (the transpose flag)
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      sm90::wgmma_m64n64k16_rs<1>(dv_acc, pa[kk],
                                  sm90::desc_add(desc_do, 2048 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      sm90::wgmma_m64n64k16_rs<1>(dk_acc, da[kk],
                                  sm90::desc_add(desc_q, 2048 * kk), 1);
    sm90::wgmma_commit();
    if (it + 1 < n_tiles) issue_sdp(it + 1);
    if (wgi == 0) {
      // dQ = dS K over the block's 128 keys: dS^T's rows and K's rows are
      // the reduction axis, both read MN-major
      sm90::bar_sync(kDsFull + buf, 256);
      const uint64_t desc_ds = sm90::desc_sw128(sm.ds[buf]);
      const uint64_t desc_kt = sm90::desc_sw128(sm.k);
      sm90::fence_regs(dq_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        sm90::wgmma_m64n64k16_ss<1, 1>(dq_acc,
                                       sm90::desc_add(desc_ds, 2048 * kk),
                                       sm90::desc_add(desc_kt, 2048 * kk),
                                       kk > 0);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s_acc);
    sm90::fence_regs(dp_acc);
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(dq_acc);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
    if (wgi == 0) {
      if (it + 2 < n_tiles) sm90::bar_arrive(kDsFree + buf, 256);
      // the tile's dq into the accumulator: staging buffer buf is free once
      // the reduction issued two tiles back has read it
      if (tw == 0) sm90::bulk_wait_read<1>();
      sm90::bar_sync(kWg0, 128);
      float2* st = reinterpret_cast<float2*>(sm.dq[buf]);
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2)
        st[128 * k2 + tw] = make_float2(dq_acc[2 * k2], dq_acc[2 * k2 + 1]);
      sm90::fence_async_smem();
      sm90::bar_sync(kWg0, 128);
      if (tw == 0) {
        sm90::bulk_reduce_add(
            p.dq_acc + ((long long)bh * p.sq_pad + it * kBM) * kD, sm.dq[buf],
            kBM * kD * 4);
        sm90::bulk_commit();
      }
    }
  }
  if (wgi == 0 && tw == 0) sm90::bulk_wait<0>();

  // dk (scaled) and dv, rows of keys below sk
  bf16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  bf16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + kr + 8 * r;
    if (key >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + (long long)key * p.dk_ss + col) =
          pack_bf16(dk_acc[4 * j + 2 * r] * p.scale,
                    dk_acc[4 * j + 2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)key * p.dv_ss + col) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the post-pass: dq = bf16(scale * accumulator)
// ---------------------------------------------------------------------------

// block (query tile, batch * head), 512 threads: 8 a row, 8 columns each.
// Column 8j + 2t + e of row 16w + g + 8r is pair 2j + r of thread
// 32w + 4g + t of warpgroup 0, element e.
__global__ void __launch_bounds__(512) flash_bwd_post(const BwdParams p) {
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int r_in = tid / 8, j = tid % 8;
  const int row = blockIdx.x * kBM + r_in;
  if (row >= p.sq) return;
  const int w = r_in / 16, g = r_in % 8, r = (r_in / 8) % 2;
  const float* tile =
      p.dq_acc + ((long long)bh * p.sq_pad + blockIdx.x * kBM) * kD;
  // the four threads t = 0..3 of pair 2j + r: 8 consecutive floats
  const float4* src =
      reinterpret_cast<const float4*>(tile + 2 * (128 * (2 * j + r) + 32 * w +
                                                  4 * g));
  const float4 a = src[0], c = src[1];
  const float mul = p.scale;  // dq = scale * dS K
  uint4 out;
  out.x = pack_bf16(a.x * mul, a.y * mul);
  out.y = pack_bf16(a.z * mul, a.w * mul);
  out.z = pack_bf16(c.x * mul, c.y * mul);
  out.w = pack_bf16(c.z * mul, c.w * mul);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + h * p.dq_sh +
                            (long long)row * p.dq_ss + 8 * j) = out;
}

// tensor map of a (batch, seq, heads, 64) view: dims innermost first
// (64, heads, seq, batch), boxes of one head's `rows` rows
int make_map(CUtensorMap* map, const bf16* base, long long sb, long long ss,
             long long sh, int heads, int seq, int batch, int rows) {
  const uint64_t dims[4] = {(uint64_t)kD, (uint64_t)heads, (uint64_t)seq,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {kD, 1, (uint32_t)rows, 1};
  return sm90_host::make_map(map, base, 4, dims, strides, box);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: bf16 (batch, seq, heads, 64) with unit
// stride on the last axis and the given element strides (batch, seq, head)
// on the other three; lse: fp32 (batch * heads, sq) from the forward.
// Scratch, fp32, sq_pad = 64 * ceil(sq / 64): dsum and lse2 (batch * heads,
// sq_pad), dq_acc (batch * heads, sq_pad, 64). Returns a cudaError_t code
// (0 on success).
extern "C" int tc_flash_bwd(int head_dim, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, float* dsum, float* lse2,
                            float* dq_acc, void* dq, void* dk, void* dv,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_ss, long long o_sh,
                            long long do_sb, long long do_ss,
                            long long do_sh, long long dq_sb, long long dq_ss,
                            long long dq_sh, long long dk_sb, long long dk_ss,
                            long long dk_sh, long long dv_sb, long long dv_ss,
                            long long dv_sh, int batch, int heads, int sq,
                            int sk, float scale, void* stream) {
  if (head_dim != kD || sq <= 0 || sk <= 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.dsum = dsum;
  p.lse2 = lse2;
  p.dq_acc = dq_acc;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = (sq + kBM - 1) / kBM * kBM;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, p.q, q_sb, q_ss, q_sh, heads, sq, batch, kBM);
  if (!err) err = make_map(&tk, p.k, k_sb, k_ss, k_sh, heads, sk, batch, kBN);
  if (!err) err = make_map(&tv, p.v, v_sb, v_ss, v_sh, heads, sk, batch, kBN);
  if (!err)
    err = make_map(&tdo, p.dout, do_sb, do_ss, do_sh, heads, sq, batch, kBM);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const dim3 qgrid(p.sq_pad / kBM, bh);
  flash_bwd_prep<<<qgrid, 512, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_kernel<<<dim3((sk + kBN - 1) / kBN, bh), kThreads, kSmemBytes,
                     s>>>(p, tq, tk, tv, tdo);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_post<<<qgrid, 512, 0, s>>>(p);
  return (int)cudaGetLastError();
}
