// Dual cross-attention for Hopper (sm_90a), bf16 in and out:
//
//   out = attn(q, kt, vt) + s_ip * attn(q, ki, vi)
//
// over token-major (B, S, H * 64) projections: the UNet attn2's text branch
// (77 tokens) and image branch (16 tokens a frame) in one pass. Replaces
// the TPU kernel tooncrafter_tpu/ops/cross_attention.py::_dual_kernel_call,
// with its rounding: scores and softmax in fp32 (the scale folded into
// exp2), p rounded to bf16 for the PV product while l sums the unrounded p,
// both branches divided and combined in fp32, and one rounding to bf16.
//
// Layout: one block per (64-row query tile, head, batch); the TPU kernel's
// loop over heads inside a grid step (a VMEM / lane artifact) is a grid axis
// here. Four warps, 16 query rows each, on mma.sync m16n8k16 from
// registers: the scores stay in registers and are reused as the A operand
// of the PV product. The head's K/V rows are staged in shared memory (80
// text rows, the 77 tokens padded and masked in the kernel, then 16 image
// rows: ~32 KB with q), so at the UNet's shapes each branch is one tile
// and no rescale of the running sums ever runs; longer contexts (the JAX
// envelope admits up to 1024 tokens a branch) loop over tiles with the
// online softmax. s_ip is read from device memory, so a learnable gate
// costs no host sync.
//
// What bounds it on the H100: q is read and the output written once
// (4 bytes an element), against 4 (77 + 16) / 4 ~ 93 products an element:
// well under the card's ~295 FLOP a byte, so the bytes do (0.031 ms at the
// ds1 shape, B = 32, Sq = 2560, C = 320). Simple first version: no TMA, no
// overlap of the tile loads with the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;   // query rows a block
constexpr int kDP = kD + 8;            // padded shared row (bank spread)
constexpr int kTextTile = 80;          // keys a text tile (77, padded)
constexpr int kImageTile = 16;         // keys an image tile

struct Params {
  const bf16* q;
  const bf16* kt;
  const bf16* vt;
  const bf16* ki;
  const bf16* vi;
  const float* s_ip;
  bf16* o;
  long long q_sb, q_ss, kt_sb, kt_ss, vt_sb, vt_ss;
  long long ki_sb, ki_ss, vi_sb, vi_ss, o_sb, o_ss;
  int heads, sq, lt, li;
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// One branch for this warp's 16 query rows: out[j][e] = acc / l in fp32,
// fragment order (c0, c1: row g, cols 8j + 2t, +1; c2, c3: row g + 8).
// BN keys a tile; sK holds [BN][kDP], sVt the tile's V transposed
// [kD][BN + 8].
template <int BN>
__device__ __forceinline__ void attend(const uint32_t qa[kD / 16][4],
                                       const bf16* kb, long long k_ss,
                                       const bf16* vb, long long v_ss,
                                       int nkeys, bf16* sK, bf16* sVt,
                                       float scale_log2, float out[kD / 8][4]) {
  constexpr int BNP = BN + 8;
  constexpr int NT = BN / 8;
  constexpr int CH = kD / 8;  // 16-byte chunks a row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum

  for (int n0 = 0; n0 < nkeys; n0 += BN) {
    __syncthreads();  // the previous tile (or branch) is consumed
    for (int i = tid; i < BN * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero4, vv = zero4;
      if (n0 + r < nkeys) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(n0 + r) * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(n0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kDP + c) = kv;
      const bf16* e = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * BNP + r] = e[j];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* k0 = sK + (j * 8 + g) * kDP + kk * 16 + 2 * t;
        mma_16816(s[j], qa[kk], ld32(k0), ld32(k0 + 8));
      }
    }

    // softmax in the exp2 domain; keys past nkeys (the text padding) masked
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t + (e & 1);
        const float x = key < nkeys ? s[j][e] * scale_log2 : neg_inf();
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mu[r] = mx[r] == neg_inf() ? 0.f : mx[r];
      const float corr = exp2f(m_r[r] - mu[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mu[e >> 1]);
        s[j][e] = p;
        l_r[e >> 1] += p;  // the unrounded p
      }
    }
    // acc += bf16(P) V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const bf16* v0 = sVt + (j * 8 + g) * BNP + kk * 16 + 2 * t;
        mma_16816(acc[j], a, ld32(v0), ld32(v0 + 8));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = acc[j][e] / l_r[e >> 1];
  }
}

__global__ void __launch_bounds__(kThreads)
dual_cross_kernel(const Params p) {
  __shared__ __align__(16) bf16 sQ[kBlockM * kDP];
  __shared__ __align__(16) bf16 sK[kTextTile * kDP];
  __shared__ __align__(16) bf16 sVt[kD * (kTextTile + 8)];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = h * kD;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  const bf16* qb = p.q + b * p.q_sb + col0;
  for (int i = tid; i < kBlockM * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = zero4;
    if (m0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(m0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * kDP + c) = val;
  }
  __syncthreads();
  // this warp's q rows as A fragments, read once for both branches
  uint32_t qa[kD / 16][4];
  const int qrow = warp * 16;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const bf16* q0 = sQ + (qrow + g) * kDP + kk * 16 + 2 * t;
    const bf16* q1 = q0 + 8 * kDP;
    qa[kk][0] = ld32(q0);
    qa[kk][1] = ld32(q1);
    qa[kk][2] = ld32(q0 + 8);
    qa[kk][3] = ld32(q1 + 8);
  }

  float ot[kD / 8][4], oi[kD / 8][4];
  attend<kTextTile>(qa, p.kt + b * p.kt_sb + col0, p.kt_ss,
                    p.vt + b * p.vt_sb + col0, p.vt_ss, p.lt, sK, sVt,
                    p.scale_log2, ot);
  attend<kImageTile>(qa, p.ki + b * p.ki_sb + col0, p.ki_ss,
                     p.vi + b * p.vi_sb + col0, p.vi_ss, p.li, sK, sVt,
                     p.scale_log2, oi);

  // the combine in fp32 (no fused multiply-add: the TPU kernel's and the
  // plain version's separate product and sum), one rounding to bf16
  const float si = __ldg(p.s_ip);
  bf16* ob = p.o + b * p.o_sb + col0;
  const int row0 = m0 + qrow + g, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = __fadd_rn(ot[j][e], __fmul_rn(si, oi[j][e]));
    const int col = j * 8 + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * p.o_ss + col) =
          pack_bf16(y[0], y[1]);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * p.o_ss + col) =
          pack_bf16(y[2], y[3]);
  }
}

}  // namespace

// q, o: bf16 (batch, sq, heads * 64); kt, vt: (batch, lt, heads * 64); ki,
// vi: (batch, li, heads * 64); each with unit stride on the channels and
// the given element strides for the batch and the rows (multiples of 8).
// s_ip: one fp32 value in device memory; scale_log2: the softmax scale times
// log2(e). Returns a cudaError_t code.
extern "C" int tc_dual_cross_attention(
    const void* q, const void* kt, const void* vt, const void* ki,
    const void* vi, const float* s_ip, void* o, long long q_sb,
    long long q_ss, long long kt_sb, long long kt_ss, long long vt_sb,
    long long vt_ss, long long ki_sb, long long ki_ss, long long vi_sb,
    long long vi_ss, long long o_sb, long long o_ss, int batch, int heads,
    int sq, int lt, int li, float scale_log2, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || lt <= 0 || li <= 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.kt = static_cast<const bf16*>(kt);
  p.vt = static_cast<const bf16*>(vt);
  p.ki = static_cast<const bf16*>(ki);
  p.vi = static_cast<const bf16*>(vi);
  p.s_ip = s_ip;
  p.o = static_cast<bf16*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss;
  p.kt_sb = kt_sb; p.kt_ss = kt_ss;
  p.vt_sb = vt_sb; p.vt_ss = vt_ss;
  p.ki_sb = ki_sb; p.ki_ss = ki_ss;
  p.vi_sb = vi_sb; p.vi_ss = vi_ss;
  p.o_sb = o_sb; p.o_ss = o_ss;
  p.heads = heads;
  p.sq = sq;
  p.lt = lt;
  p.li = li;
  p.scale_log2 = scale_log2;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  dual_cross_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
