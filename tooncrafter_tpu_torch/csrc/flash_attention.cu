// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax.
//
// Replaces the four TPU forward kernels of
// tooncrafter_tpu/ops/flash_attention.py:
//   * _flash_mh_packed    UNet attn1 on a packed (B, S, 3C) projection
//   * _flash_mh           the same on separate token-major (B, S, C) tensors
//   * _flash_bh_with_lse  two-pass online softmax over (BH, S, 64), + lse
//   * _flash_bh_single    whole-KV single pass, here at d = 512, + lse
// One templated kernel serves all four: the caller passes element strides
// for the batch, sequence and head axes of q, k, v and o, so the packed
// projection and the token-major layouts are read in place, with no copy.
//
// Its ONES flag (entry tc_flash_fwd_ones) is the fifth, _flash_mh_ones: the
// normalizer l sums the bf16-rounded p that the PV product consumes, where
// the others sum the unrounded p. The TPU kernel gets that sum from the
// matrix unit's idle output lanes by appending a block of ones to V outside
// the kernel ((B, S, H * 2D)); here the row sum is a register add of the
// same rounded value, rescaled with the running max exactly as the
// accumulator is, so no [v | ones] tensor is built.
//
// What bounds it on the H100: at d = 64 every score costs one 64-deep
// product on the tensor cores but also an exp2, a max and a rescale on the
// FP32 units, so the softmax work, not the tensor-core rate, sets the pace.
// The design keeps that work minimal: scores stay in registers (they are
// reused as the A operand of the PV product without a trip through shared
// memory), the scale is folded into one multiply in the exp2 domain, the
// row sum is kept per thread and reduced across the quad once at the end,
// and the ragged edges are masked in the kernel instead of padding inputs.
// This is the simple first version: mma.sync m16n8k16 from registers with
// plain shared-memory staging; TMA, wgmma and warp specialisation are left
// for later work.
//
// d = 512 (the VAE mid attention, one head): a 64 x 512 fp32 accumulator
// does not fit in one warpgroup's registers, so the value axis is split over
// blockIdx.z in slices of 128 columns and each slice recomputes Q K^T over
// the full 512-deep product (4x the QK work). The alternative, O in shared
// memory, needs 128 KB for O alone and leaves one block per SM with a K
// tile of at most 32 rows; the split keeps every block's state in registers
// and reuses the d = 64 code path unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (batch * heads, sq) or null
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk;
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// D: q/k head dim. DV: value columns one block computes (blockIdx.z picks
// the slice). BN: keys per tile. Shared rows are padded by 8 elements so
// the quad-strided 32-bit fragment loads hit 32 distinct banks. ONES: the
// row sum adds bf16(p), the value the PV product reads (_flash_mh_ones).
template <int D, int DV, int BN, bool ONES>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int DP = D + 8;
  constexpr int BNP = BN + 8;
  constexpr int NT_S = BN / 8;   // score tiles (n = 8) per warp row block
  constexpr int NT_O = DV / 8;   // output tiles per warp row block
  constexpr int QCH = D / 8;     // 16-byte chunks per q/k row
  constexpr int VCH = DV / 8;    // 16-byte chunks per v row slice

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBlockM][DP]
  bf16* sK = sQ + kBlockM * DP;                  // [BN][DP]
  bf16* sVt = sK + BN * DP;                      // [DV][BNP], V transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int dv0 = blockIdx.z * DV;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBlockM * QCH; i += kThreads) {
    const int r = i / QCH;
    const int c = (i % QCH) * 8;
    uint4 val = zero4;
    if (m0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(m0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * DP + c) = val;
  }

  float o_acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
    o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum
  const int qrow = warp * 16;

  for (int n0 = 0; n0 < p.sk; n0 += BN) {
    __syncthreads();  // the previous tile is consumed; sQ is written
    for (int i = tid; i < BN * QCH; i += kThreads) {
      const int r = i / QCH;
      const int c = (i % QCH) * 8;
      uint4 val = zero4;
      if (n0 + r < p.sk)
        val = *reinterpret_cast<const uint4*>(kb + (long long)(n0 + r) * p.k_ss + c);
      *reinterpret_cast<uint4*>(sK + r * DP + c) = val;
    }
    for (int i = tid; i < BN * VCH; i += kThreads) {
      const int r = i / VCH;
      const int c = (i % VCH) * 8;
      uint4 val = zero4;
      if (n0 + r < p.sk)
        val = *reinterpret_cast<const uint4*>(vb + (long long)(n0 + r) * p.v_ss + dv0 + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * BNP + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* q0 = sQ + (qrow + g) * DP + kk * 16 + 2 * t;
      const bf16* q1 = q0 + 8 * DP;
      uint32_t a[4] = {ld32(q0), ld32(q1), ld32(q0 + 8), ld32(q1 + 8)};
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* k0 = sK + (j * 8 + g) * DP + kk * 16 + 2 * t;
        mma_16816(s[j], a, ld32(k0), ld32(k0 + 8));
      }
    }

    // online softmax in the exp2 domain; c0,c1 are row g, c2,c3 row g + 8
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t + (e & 1);
        const float x = key < p.sk ? s[j][e] * p.scale_log2 : neg_inf();
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
      for (int j = 0; j < NT_O; ++j) {
        o_acc[j][2 * r] *= corr;
        o_acc[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[j][e] - mu[e >> 1]);
        s[j][e] = pv;
        l_r[e >> 1] += ONES ? round_bf16(pv) : pv;
      }
    }

    // O += P V: the score accumulators are already in A-fragment order
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const bf16* v0 = sVt + (j * 8 + g) * BNP + kk * 16 + 2 * t;
        mma_16816(o_acc[j], a, ld32(v0), ld32(v0 + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
  }
  const int row0 = m0 + qrow + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int col = dv0 + j * 8 + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * p.o_ss + col) =
          pack_bf16(o_acc[j][0] * inv[0], o_acc[j][1] * inv[0]);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * p.o_ss + col) =
          pack_bf16(o_acc[j][2] * inv[1], o_acc[j][3] * inv[1]);
  }
  if (p.lse != nullptr && blockIdx.z == 0 && t == 0) {
    float* lse = p.lse + (long long)bh * p.sq;
    if (row0 < p.sq) lse[row0] = (m_r[0] + log2f(l_r[0])) * kLn2;
    if (row1 < p.sq) lse[row1] = (m_r[1] + log2f(l_r[1])) * kLn2;
  }
}

template <int D, int DV, int BN, bool ONES = false>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (kBlockM * (D + 8) + BN * (D + 8) + DV * (BN + 8)) *
                   (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DV, BN, ONES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, batch * p.heads, D / DV);
  flash_fwd_kernel<D, DV, BN, ONES><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   float* lse, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh, int heads,
                   int sq, int sk, float scale) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// q, k, v, o: bf16 (batch, seq, heads, head_dim) with unit stride on the
// last axis and the given element strides on the other three; lse: fp32
// (batch * heads, sq) or null. Returns a cudaError_t code (0 on success).
extern "C" int tc_flash_fwd(int head_dim, const void* q, const void* k,
                            const void* v, void* o, float* lse,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_ss, long long o_sh,
                            int batch, int heads, int sq, int sk, float scale,
                            void* stream) {
  if (sq <= 0 || sk <= 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss,
                               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, heads,
                               sq, sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64, 64, 64>(p, batch, s);
  if (head_dim == 512) return launch<512, 128, 32>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The same at head_dim 64 with the normalizer of _flash_mh_ones (the sum of
// the bf16-rounded p) and no lse.
extern "C" int tc_flash_fwd_ones(const void* q, const void* k, const void* v,
                                 void* o, long long q_sb, long long q_ss,
                                 long long q_sh, long long k_sb,
                                 long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss,
                                 long long v_sh, long long o_sb,
                                 long long o_ss, long long o_sh, int batch,
                                 int heads, int sq, int sk, float scale,
                                 void* stream) {
  if (sq <= 0 || sk <= 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, nullptr, q_sb, q_ss, q_sh, k_sb,
                               k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                               heads, sq, sk, scale);
  return launch<64, 64, 64, true>(p, batch, static_cast<cudaStream_t>(stream));
}
