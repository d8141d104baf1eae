// Flash-attention backward for Hopper (sm_90a), d = 64, bf16 operands,
// fp32 accumulation.
//
// Replaces the TPU kernel tooncrafter_tpu/ops/flash_attention.py::
// _flash_bwd_bh (its two pallas_calls). The standard formulation (Dao 2022):
// with the forward's lse, p = exp(scale q k^T - lse) is recomputed tile by
// tile, D = rowsum(dO * O), and
//   dv = p^T dO,   ds = p * (dO v^T - D),   dq = scale ds k,
//   dk = scale ds^T q.
// As on the TPU, two kernels and no atomics:
//   * flash_bwd_dq_kernel: one block per 64 query rows of one (batch, head);
//     it computes D for its rows (written to global memory for the second
//     kernel) and loops over all key tiles, accumulating dq in registers;
//   * flash_bwd_dkv_kernel: one block per 64 keys; it loops over all query
//     tiles, accumulating dk and dv in registers.
// The dq kernel runs first on the stream, so D is complete when the dk/dv
// kernel reads it. q, k, v, O, dO and the three gradients are read and
// written at the caller's element strides (batch, sequence, head), so the
// packed (B, S, 3C) projection and its gradient are used in place.
//
// What bounds it on the H100: five 64-deep products per (query, key) pair
// (S and dP in both kernels, plus dq in one and dk, dv in the other, i.e.
// seven products where the needed work is five), and an exp2 per score in
// each kernel. This is the simple first version: mma.sync m16n8k16 from
// registers, plain shared-memory staging, 4 warps of 16 rows; p and ds are
// rounded to bf16 before their products, as the TPU kernel does. TMA,
// wgmma and a fused single pass are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;     // rows a block owns, 16 per warp
constexpr int kDP = kD + 8;            // padded shared row (144 bytes)
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (batch * heads, sq), natural log
  float* dsum;       // (batch * heads, sq): D, written by the dq kernel
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
  int heads, sq, sk;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// rows [r0, r0 + kTile) of a (rows, 64) bf16 operand at row stride ss into
// a padded shared tile; rows at or past n are zero
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base,
                                          long long ss, int r0, int n,
                                          int tid) {
  for (int i = tid; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(s + r * kDP + c) = val;
  }
}

// A fragments of rows [row0, row0 + 16), columns [16 kk, 16 kk + 16) of a
// padded shared tile
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int row0,
                                       int kk, int g, int t) {
  const bf16* p0 = s + (row0 + g) * kDP + kk * 16 + 2 * t;
  const bf16* p1 = p0 + 8 * kDP;
  a[0] = ld32(p0); a[1] = ld32(p1); a[2] = ld32(p0 + 8); a[3] = ld32(p1 + 8);
}

// acc (16 x 64) += A (16 x 64, shared rows row0..) * Y^T, Y a shared (64, 64)
// tile stored row-major (its rows are the product's n axis)
__device__ __forceinline__ void gemm_abt(float acc[8][4], const bf16* sA,
                                         int row0, const bf16* sY, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    load_a(a, sA, row0, kk, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* y = sY + (j * 8 + g) * kDP + kk * 16 + 2 * t;
      mma_16816(acc[j], a, ld32(y), ld32(y + 8));
    }
  }
}

// acc (16 x 64) += P (16 x 64, fp32 accumulator layout, rounded to bf16)
// * Y, Y a shared (64, 64) tile stored row-major (its rows are the
// product's k axis), read transposed by ldmatrix
__device__ __forceinline__ void gemm_pv(float acc[8][4], const float p[8][4],
                                        const bf16* sY, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, sY + (kk * 16 + (lane & 15)) * kDP + j * 8);
      mma_16816(acc[j], a, b[0], b[1]);
    }
  }
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// rows row0 and row0 + 8 of a 16 x 64 accumulator, times `mul`, as bf16
__device__ __forceinline__ void store_rows(bf16* base, long long ss, int row0,
                                           int n, const float acc[8][4],
                                           float mul, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(base + (long long)row0 * ss + col) =
          pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(base + (long long)row1 * ss + col) =
          pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  __shared__ __align__(16) bf16 sQ[kTile * kDP];
  __shared__ __align__(16) bf16 sDO[kTile * kDP];
  __shared__ __align__(16) bf16 sK[kTile * kDP];
  __shared__ __align__(16) bf16 sV[kTile * kDP];
  __shared__ float sL[kTile];  // lse * log2(e); +inf past the last row
  __shared__ float sD[kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;

  load_tile(sQ, qb, p.q_ss, m0, p.sq, tid);
  load_tile(sDO, dob, p.do_ss, m0, p.sq, tid);
  // D = rowsum(dO * O) in fp32: two lanes a row, 32 columns each
  {
    const int r = warp * 16 + (lane >> 1);
    const int row = m0 + r;
    float acc = 0.f;
    if (row < p.sq) {
      const bf16* orow = ob + (long long)row * p.o_ss + (lane & 1) * 32;
      const bf16* drow = dob + (long long)row * p.do_ss + (lane & 1) * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 2) {
        const float2 x = ld_bf162(orow + c);
        const float2 y = ld_bf162(drow + c);
        acc += x.x * y.x + x.y * y.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      sD[r] = acc;
      sL[r] = row < p.sq ? p.lse[(long long)bh * p.sq + row] * kLog2e : pos_inf();
      if (row < p.sq) p.dsum[(long long)bh * p.sq + row] = acc;
    }
  }
  __syncthreads();

  const int qrow = warp * 16;
  const float l2[2] = {sL[qrow + g], sL[qrow + g + 8]};
  const float dr[2] = {sD[qrow + g], sD[qrow + g + 8]};
  float dq[8][4];
  zero(dq);

  for (int n0 = 0; n0 < p.sk; n0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile(sK, kb, p.k_ss, n0, p.sk, tid);
    load_tile(sV, vb, p.v_ss, n0, p.sk, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    gemm_abt(s, sQ, qrow, sK, g, t);    // S = Q K^T
    gemm_abt(dp, sDO, qrow, sV, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t + (e & 1);
        const float pv = key < p.sk
            ? exp2f(s[j][e] * p.scale_log2 - l2[e >> 1]) : 0.f;
        s[j][e] = pv * (dp[j][e] - dr[e >> 1]);  // ds
      }
    }
    gemm_pv(dq, s, sK, lane);  // dq += ds K
  }
  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, m0 + qrow + g, p.sq,
             dq, p.scale, t);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdParams p) {
  __shared__ __align__(16) bf16 sK[kTile * kDP];
  __shared__ __align__(16) bf16 sV[kTile * kDP];
  __shared__ __align__(16) bf16 sQ[kTile * kDP];
  __shared__ __align__(16) bf16 sDO[kTile * kDP];
  __shared__ float sL[kTile];
  __shared__ float sD[kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + (long long)bh * p.sq;
  const float* dsum = p.dsum + (long long)bh * p.sq;

  load_tile(sK, kb, p.k_ss, n0, p.sk, tid);
  load_tile(sV, vb, p.v_ss, n0, p.sk, tid);

  const int krow = warp * 16;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  for (int m0 = 0; m0 < p.sq; m0 += kTile) {
    __syncthreads();  // the previous Q/dO tile is consumed
    load_tile(sQ, qb, p.q_ss, m0, p.sq, tid);
    load_tile(sDO, dob, p.do_ss, m0, p.sq, tid);
    if (tid < kTile) {
      const int row = m0 + tid;
      sL[tid] = row < p.sq ? lse[row] * kLog2e : pos_inf();
      sD[tid] = row < p.sq ? dsum[row] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    gemm_abt(st, sK, krow, sQ, g, t);    // S^T = K Q^T
    gemm_abt(dpt, sV, krow, sDO, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);  // query within the tile
        const float pv = exp2f(st[j][e] * p.scale_log2 - sL[col]);
        st[j][e] = pv;                            // p^T
        dpt[j][e] = pv * (dpt[j][e] - sD[col]);   // ds^T
      }
    }
    gemm_pv(dv, st, sDO, lane);  // dv += p^T dO
    gemm_pv(dk, dpt, sQ, lane);  // dk += ds^T Q
  }
  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, n0 + krow + g, p.sk,
             dk, p.scale, t);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, n0 + krow + g, p.sk,
             dv, 1.f, t);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: bf16 (batch, seq, heads, 64) with unit
// stride on the last axis and the given element strides (batch, seq, head)
// on the other three; lse: fp32 (batch * heads, sq) from the forward;
// dsum: fp32 (batch * heads, sq) scratch. Returns a cudaError_t code (0 on
// success).
extern "C" int tc_flash_bwd(int head_dim, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, float* dsum, void* dq, void* dk,
                            void* dv, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, long long o_sb, long long o_ss,
                            long long o_sh, long long do_sb, long long do_ss,
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
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  flash_bwd_dq_kernel<<<dim3((sq + kTile - 1) / kTile, bh), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<<<dim3((sk + kTile - 1) / kTile, bh), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
