// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax.
//
// Replaces the five TPU forward kernels of
// tooncrafter_tpu/ops/flash_attention.py:
//   * _flash_mh_packed    UNet attn1 on a packed (B, S, 3C) projection
//   * _flash_mh           the same on separate token-major (B, S, C) tensors
//   * _flash_bh_with_lse  two-pass online softmax over (BH, S, D), + lse
//   * _flash_bh_single    whole-KV single pass over (BH, S, D), + lse
//   * _flash_mh_ones      _flash_mh with the ones-column normalizer
// The caller passes element strides for the batch, sequence and head axes
// of q, k, v and o, so the packed projection and the token-major layouts
// are read in place, with no copy.
//
// The entry's `ones` flag gives the normalizer of the TPU kernels that
// append a block of ones to V outside the kernel: _flash_mh_ones
// ((B, S, H * 2D)) and the two (BH, S, D) kernels ((BH, S, 2D)). Their l
// sums the bf16-rounded p that the PV product consumes, and their lse is
// m + log(l) of that sum; _flash_mh and _flash_mh_packed sum the unrounded
// p. Both are rescaled with the running max as the accumulator is.
//
// What bounds it on the H100: at d = 64 every score costs one 64-deep
// product on the tensor cores but also an exp2, a max and a rescale on the
// FP32 units, about as many cycles as the products, so the two have to
// overlap. Head dim 64 (namespace wg; #1, #2, #3, #5 and the models' every
// d = 64 attention):
//   * three consumer warpgroups of 64 query rows (192 a block) run S = Q K^T
//     and O += P V on wgmma: Q and K from shared memory, P from registers
//     (the S accumulator is already in the A-fragment order), V read in its
//     key-major layout through wgmma's transpose of B, so nothing is
//     transposed;
//   * a producer thread fills a 3-stage ring of 128-key K and V tiles with
//     TMA (128-byte swizzle) on mbarriers, the consumers free a stage when
//     its products are done; setmaxnreg moves the producer warpgroup's
//     registers to the consumers;
//   * each warpgroup issues tile i's S, then tile i - 1's PV, and runs tile
//     i's softmax while the PV runs (exp2 in the ex2.approx unit, the scale
//     folded into one FMA);
//   * with `ones` the normalizer is the PV product's extra 8 columns, whose
//     B is a tile of ones beside each V tile (the descriptor's leading
//     offset): the tensor cores sum the bf16 p they consume, as the TPU
//     kernels' matrix unit does, and the FP32 units skip the row sum;
//   * ragged Sq and Sk are masked in the kernel (TMA fills rows past the
//     end with zeros; keys past Sk score -inf), and the output leaves
//     through shared memory in 16-byte rows.
//
// d = 512 (the VAE mid attention, one head; #3 and #4 there) keeps the
// first version: mma.sync m16n8k16 from registers, plain shared-memory
// staging, 64 query rows and 32 keys a tile. A 64 x 512 fp32 accumulator
// does not fit in one warpgroup's registers, so the value axis is split
// over blockIdx.z in slices of 128 columns and each slice recomputes
// Q K^T over the full 512-deep product (4x the QK work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

__device__ __forceinline__ float ex2(float x) {  // 2^x, ex2.approx (ftz)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// row sum adds bf16(p), the value the PV product reads. Built at d = 512.
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
        // with ONES, l sums the bf16-rounded p that the PV product reads
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

// ---------------------------------------------------------------------------
// head dim 64: wgmma with a TMA-fed K/V ring
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kD = 64;
constexpr int kBM = 192;              // query rows a block: 3 warpgroups
constexpr int kBN = 128;              // keys a tile
constexpr int kStages = 3;            // the K/V ring
constexpr int kConsumers = kBM / 64;  // warpgroups running products
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTile = kBN * kD * 2;   // bytes of a K or V tile

struct Smem {  // 1024-byte aligned: every tile is a whole number of atoms
  bf16 q[kBM * kD];
  bf16 k[kStages][kBN * kD];
  bf16 v[kStages][kBN * kD];
  bf16 ones[kBN * kD];  // the B of the ones column (`ones`)
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;

// Warpgroups 0 .. kConsumers - 1 each own 64 query rows; the last
// warpgroup's first thread issues the TMA loads (Q once, then K and V of
// every key tile into the ring), the rest of it idles.
template <bool ONES>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const Params p, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int m0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n_tiles = (p.sk + kBN - 1) / kBN;

  if (tid == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);  // one per warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the normalizer of ONES: a product of P with 8 columns of ones (the
  // ones column), beside each tile's PV, sums the bf16 p that PV reads; it
  // starts from zero every tile and its sums go into l in fp32, rescaled
  // with the accumulator (summed on the tensor cores into a running total,
  // l drifts by 1e-4 over 576 tiles); otherwise the threads sum the
  // unrounded p

  if (wgi == kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      sm90::mbar_expect_tx(&sm.q_full, kBM * kD * 2);
      sm90::tma_load_4d(sm.q, &tm_q, &sm.q_full, 0, h, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.k_full[s], kTile);
        sm90::tma_load_4d(sm.k[s], &tm_k, &sm.k_full[s], 0, h, it * kBN, b);
        sm90::mbar_expect_tx(&sm.v_full[s], kTile);
        sm90::tma_load_4d(sm.v[s], &tm_v, &sm.v_full[s], 0, h, it * kBN, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");

  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int g = lane >> 2, t = lane & 3;
  bf16* q_tile = sm.q + wgi * 64 * kD;
  const uint64_t desc_q = sm90::desc_sw128(q_tile);
  const float sl2 = p.scale_log2;

  if constexpr (ONES) {  // the ones tile, read by wgmma
    uint4* ones = reinterpret_cast<uint4*>(sm.ones);
    for (int i = tid; i < kTile / 16; i += kConsumers * 128)
      ones[i] = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                           0x3f803f80u);  // bf16 1.0
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 15, %0;\n" ::"n"(kConsumers * 128) : "memory");
  }

  float o_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o_acc[i] = 0.f;
  float l_acc[4];  // the ones column's sums of a tile: rows g, g + 8
  float m_r[2] = {neg_inf(), neg_inf()};  // running max of the raw scores
  float l_r[2] = {0.f, 0.f};  // the row sums (without the ones column, this
                              // thread's share)
  float sc[kBN / 2];                      // S, then p, of the current tile
  uint32_t pa[kBN / 16][4];               // the previous tile's p, bf16

  // S = Q K^T of tile `it` into sc: 64 x 128, K-major from both tiles
  auto issue_s = [&](int it) {
    const int s = it % kStages;
    sm90::mbar_wait(&sm.k_full[s], (it / kStages) & 1);
    const uint64_t desc_k = sm90::desc_sw128(sm.k[s]);
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::wgmma_m64n128k16_ss<0>(sc, sm90::desc_add(desc_q, 32 * kk),
                                   sm90::desc_add(desc_k, 32 * kk), kk > 0);
    sm90::wgmma_commit();
  };
  // O += P V of tile `it` (pa), and the ones column: V's tile key-major,
  // read MN-major (the transpose flag)
  auto issue_pv = [&](int it) {
    const int s = it % kStages;
    sm90::mbar_wait(&sm.v_full[s], (it / kStages) & 1);
    const uint64_t desc_v = sm90::desc_sw128(sm.v[s]);
    const uint64_t desc_1 = sm90::desc_sw128(sm.ones);
    sm90::fence_regs(o_acc);
    sm90::fence_regs(l_acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      sm90::wgmma_m64n64k16_rs<1>(o_acc, pa[kk],
                                  sm90::desc_add(desc_v, 2048 * kk), 1);
      if constexpr (ONES)
        sm90::wgmma_m64n8k16_rs<1>(l_acc, pa[kk],
                                   sm90::desc_add(desc_1, 2048 * kk), kk > 0);
    }
    sm90::wgmma_commit();
  };
  // the online softmax of tile `it` in sc (sc[4j + e]: row g + 8 (e / 2),
  // key 8j + 2t + (e % 2) of the tile), in the exp2 domain: p in place,
  // the rows' new max (and without the ones column l rescaled and added
  // to); returns the factor that rescales O to the new max
  auto softmax = [&](int it, float (&corr)[2]) {
    const int n0 = it * kBN;
    if (n0 + kBN > p.sk) {  // the ragged last tile: keys past sk
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + 8 * j + 2 * t + (e & 1) >= p.sk) sc[4 * j + e] = neg_inf();
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m_r[r] - mx[r]) * sl2);  // 0 on the first tile
      m_r[r] = mx[r];
      ms[r] = mx[r] * sl2;
      if constexpr (!ONES) l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ex2(fmaf(sc[4 * j + e], sl2, -ms[e >> 1]));
        sc[4 * j + e] = pv;
        if constexpr (!ONES) l_r[e >> 1] += pv;
      }
  };
  auto pack_p = [&]() {  // sc -> pa, in the A-fragment order of PV
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  auto release = [&](int it) {
    if (lane == 0) sm90::mbar_arrive(&sm.empty[it % kStages]);
  };

  sm90::mbar_wait(&sm.q_full, 0);
  float corr[2];
  issue_s(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  softmax(0, corr);
  pack_p();
  // tile it's S runs on the tensor cores, then tile it - 1's PV, while
  // this warpgroup's softmax of tile it waits only for the S
  for (int it = 1; it < n_tiles; ++it) {
    issue_s(it);
    issue_pv(it - 1);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);
    softmax(it, corr);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o_acc);
    sm90::fence_regs(l_acc);
    sm90::fence_regs(pa);
    if constexpr (ONES) {  // tile it - 1's sums into l
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = (l_r[r] + l_acc[2 * r]) * corr[r];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o_acc[4 * j + 0] *= corr[0];
      o_acc[4 * j + 1] *= corr[0];
      o_acc[4 * j + 2] *= corr[1];
      o_acc[4 * j + 3] *= corr[1];
    }
    release(it - 1);
    pack_p();
  }
  issue_pv(n_tiles - 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o_acc);
  sm90::fence_regs(l_acc);
  sm90::fence_regs(pa);
  release(n_tiles - 1);

  float inv[2];  // every row has a valid key 0: l >= 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (ONES) {
      l_r[r] += l_acc[2 * r];  // the last tile's
    } else {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    inv[r] = 1.f / l_r[r];
  }
  // the output tile through this warpgroup's (consumed) Q tile: 16-byte
  // chunk c of row r at chunk c ^ (r % 8), then 16-byte rows out
  uint4* stage = reinterpret_cast<uint4*>(q_tile);
  const int row0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(stage + row * 8 + (j ^ (row & 7)));
      dst[t] = pack_bf16(o_acc[4 * j + 2 * r] * inv[r],
                         o_acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(wgi + 1) : "memory");
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const int tw = tid & 127;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (tw >> 3) + 16 * i;
    const int c = tw & 7;
    const int qrow = m0 + wgi * 64 + row;
    if (qrow < p.sq)
      *reinterpret_cast<uint4*>(ob + (long long)qrow * p.o_ss + 8 * c) =
          stage[row * 8 + (c ^ (row & 7))];
  }
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + (long long)bh * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = m0 + wgi * 64 + row0 + 8 * r;
      if (qrow < p.sq) lse[qrow] = (m_r[r] * sl2 + log2f(l_r[r])) * kLn2;
    }
  }
}

// tensor maps of a (batch, seq, heads, 64) view: dims innermost first
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

template <bool ONES>
int launch(const Params& p, int batch, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, p.q_sb, p.q_ss, p.q_sh, p.heads, p.sq, batch,
                     kBM);
  if (!err)
    err = make_map(&tk, p.k, p.k_sb, p.k_ss, p.k_sh, p.heads, p.sk, batch,
                   kBN);
  if (!err)
    err = make_map(&tv, p.v, p.v_sb, p.v_ss, p.v_sh, p.heads, p.sk, batch,
                   kBN);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<ONES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.sq + kBM - 1) / kBM, batch * p.heads);
  flash_fwd_wgmma<ONES><<<grid, kThreads, kSmemBytes, stream>>>(p, tq, tk,
                                                               tv);
  return (int)cudaGetLastError();
}

}  // namespace wg

constexpr int kBN512 = 32;  // keys a tile of the d = 512 kernel

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
// (batch * heads, sq) or null. ones: the normalizer sums the bf16-rounded
// p (#3, #4, #5), else the unrounded p (#1, #2). Returns a cudaError_t code
// (0 on success).
extern "C" int tc_flash_fwd(int head_dim, int ones, const void* q,
                            const void* k, const void* v, void* o, float* lse,
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
  if (head_dim == 64)
    return ones ? wg::launch<true>(p, batch, s)
                : wg::launch<false>(p, batch, s);
  if (head_dim == 512)
    return ones ? launch<512, 128, kBN512, true>(p, batch, s)
                : launch<512, 128, kBN512>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

// Keys a tile of the forward kernel at head_dim, 0 for a head dim it does
// not take: where its running max moves, so where the rounded-p normalizer
// rounds p.
extern "C" int tc_flash_key_tile(int head_dim) {
  return head_dim == 64 ? wg::kBN : head_dim == 512 ? kBN512 : 0;
}
