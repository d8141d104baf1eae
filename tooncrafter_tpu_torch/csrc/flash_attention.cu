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
// Head dim 512 (namespace wg512; the VAE mid attention, one head: #4, and
// #3 where K/V is past the single-pass cap). Each score costs a 512-deep
// product (2048 tensor-core operations) against a handful of FP32 ones, so
// the products bound it, and with them the K/V traffic: a block of 64
// query rows does only ~64 operations per byte of K/V it reads, and a
// 64 x 512 fp32 accumulator is half an SM's registers, so one block of 64
// rows is all an SM holds. The design:
//   * S = Q K^T of each 64-key tile is computed once, on wgmma, by
//     consumer warpgroup 0: Q (64 KB) and K from shared memory, the depth
//     as 8 swizzle atoms of 64 columns;
//   * the online softmax (warpgroup 0) leaves bf16 P and the rows' rescale
//     factor in shared memory on an mbarrier (two buffers); both consumer
//     warpgroups add P V to their half of O (256 value columns, 128 fp32
//     registers a thread), P the A operand from shared memory, V read
//     key-major through wgmma's transpose of B (the leading offset steps
//     from one atom of V to the next);
//   * two producer threads keep K and V tiles coming by TMA on mbarriers,
//     K as soon as S is done with the buffer, V once P V is;
//   * the two blocks of a cluster are neighbouring query tiles of one head:
//     each loads half of every K/V tile's atoms and multicasts it into
//     both (128 query rows per K/V read from L2), and frees a buffer only
//     once both blocks are done with it;
//   * l sums the bf16 p (the `ones` normalizer, the only one it takes) at
//     one running max per 64-key tile, the rounding point of
//     _plain_bh_ones(block=64) (tc_flash_key_tile);
//   * ragged Sq and Sk are masked as at d = 64; a block past Sq (an odd
//     number of query tiles) loads its half of the pair's K/V and stores
//     nothing; the output leaves through the consumed Q tile.
// At one head (the per-frame encoder) the grid is ceil(Sq / 64) blocks:
// 40 at S = 2560, 144 at S = 9216, where 132 SMs take one each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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

// tensor map of a (batch, seq, heads, d) view: dims innermost first
// (d, heads, seq, batch), boxes of 64 columns of one head's `rows` rows
int make_map(CUtensorMap* map, const bf16* base, int d, long long sb,
             long long ss, long long sh, int heads, int seq, int batch,
             int rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)heads, (uint64_t)seq,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return sm90_host::make_map(map, base, 4, dims, strides, box);
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
    sm90::fence_async_smem();
    sm90::bar_sync(15, kConsumers * 128);
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
  sm90::bar_sync(wgi + 1, 128);
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

template <bool ONES>
int launch(const Params& p, int batch, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, kD, p.q_sb, p.q_ss, p.q_sh, p.heads, p.sq,
                     batch, kBM);
  if (!err)
    err = make_map(&tk, p.k, kD, p.k_sb, p.k_ss, p.k_sh, p.heads, p.sk,
                   batch, kBN);
  if (!err)
    err = make_map(&tv, p.v, kD, p.v_sb, p.v_ss, p.v_sh, p.heads, p.sk,
                   batch, kBN);
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

// ---------------------------------------------------------------------------
// head dim 512: wgmma, a TMA-fed K/V ring multicast to a cluster pair
// ---------------------------------------------------------------------------

namespace wg512 {

constexpr int kD = 512;
constexpr int kBM = 64;             // query rows a block
constexpr int kBN = 64;             // keys a tile
constexpr int kPair = 2;            // blocks of a cluster: two query tiles
constexpr int kAtoms = kD / 64;     // 64-column swizzle atoms of a row
constexpr int kMine = kAtoms / kPair;  // atoms of a K/V tile a block loads
constexpr int kHalf = kAtoms / 2;   // atoms of O (and of V) a warpgroup owns
constexpr int kThreads = 3 * 128;   // two consumer warpgroups, the producer
constexpr int kQBytes = kBM * kD * 2;
constexpr int kTileBytes = kBN * kD * 2;  // a K or a V tile

// Every operand tile is stored as its 64-column atoms one after another
// ([atom][row][64]): rows of 128 bytes, 128-byte swizzle.
struct Smem {  // 1024-byte aligned
  bf16 q[kBM * kD];
  bf16 k[kBN * kD];
  bf16 v[kBN * kD];
  bf16 p[2][kBM * kBN];  // the bf16 P of a tile, read by both warpgroups
  float corr[2][kBM];    // the factor rescaling O to the tile's max
  float inv[kBM];        // 1 / l
  uint64_t q_full, k_full, v_full, k_empty, v_empty;
  uint64_t p_full[2], p_empty[2];
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;

// Block (query tile x, head y) of a cluster pair: x and x ^ 1 share every
// K/V tile, each loading half of its atoms into both blocks (TMA
// multicast). Warpgroup 0 computes S = Q K^T of each tile (once), the
// online softmax and its bf16 P, which it leaves in shared memory; both
// consumer warpgroups then add P V to their half of O (256 value columns,
// 128 fp32 registers a thread). Two threads of the producer warpgroup
// issue the loads.
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d512(const Params p, const __grid_constant__ CUtensorMap tm_q,
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
  const int rank = (int)sm90::cluster_rank();
  const uint32_t peer = rank ^ 1;

  if (tid == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    sm90::mbar_init(&sm.k_full, 1);
    sm90::mbar_init(&sm.v_full, 1);
    sm90::mbar_init(&sm.k_empty, kPair * 4);  // warpgroup 0's warps, both
    sm90::mbar_init(&sm.v_empty, kPair * 8);  // every consumer warp, both
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&sm.p_full[i], 128);  // warpgroup 0's threads
      sm90::mbar_init(&sm.p_empty[i], 8);   // this block's consumer warps
    }
    sm90::mbar_fence_init();
  }
  sm90::cluster_sync();  // the peer's barriers are set up too

  if (wgi == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // one thread fills the K ring (after Q), another the V ring, so that
    // each tile is requested as soon as both blocks are done with the
    // buffer, K (after S) well before V (after P V)
    const bool k_side = tid == 256;
    if (k_side || tid == 288) {
      if (k_side) {
        sm90::mbar_expect_tx(&sm.q_full, kQBytes);
        for (int a = 0; a < kAtoms; ++a)
          sm90::tma_load_4d(sm.q + a * kBM * 64, &tm_q, &sm.q_full, 64 * a,
                            h, m0, b);
      }
      uint64_t* full = k_side ? &sm.k_full : &sm.v_full;
      uint64_t* empty = k_side ? &sm.k_empty : &sm.v_empty;
      bf16* tile = k_side ? sm.k : sm.v;
      const CUtensorMap* map = k_side ? &tm_k : &tm_v;
      for (int it = 0; it < n_tiles; ++it) {
        // a buffer is refilled once both blocks are done with it
        sm90::mbar_wait<true>(empty, (it & 1) ^ 1);
        sm90::mbar_expect_tx(full, kTileBytes);
        for (int a = rank * kMine; a < (rank + 1) * kMine; ++a)
          sm90::tma_load_4d_mc(tile + a * kBN * 64, map, full, 64 * a, h,
                               it * kBN, b, 0x3);
      }
    }
    sm90::cluster_sync();  // the peer's arrivals and loads have landed
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;   // this thread's rows: row0, row0 + 8
  const float sl2 = p.scale_log2;
  // one arrival on a barrier of this block and on its peer's
  auto release = [&](uint64_t* bar) {
    if (lane == 0) {
      sm90::mbar_arrive(bar);
      sm90::mbar_arrive_peer(sm90::peer_addr(bar, peer));
    }
  };

  float o_acc[128];  // O of this warpgroup's 256 value columns
#pragma unroll
  for (int i = 0; i < 128; ++i) o_acc[i] = 0.f;
  // O += P V of tile `it`: P (64 x 64 keys) K-major, V's tile key-major
  // read MN-major (the transpose flag); the leading offset steps from one
  // 64-column atom of V to the next
  auto issue_pv = [&](int it) {
    sm90::mbar_wait(&sm.v_full, it & 1);
    const uint64_t desc_p = sm90::desc_sw128(sm.p[it & 1]);
    const uint64_t desc_v = sm90::desc_sw128(
        sm.v + wgi * (kHalf * kBN * 64), 1024, kBN * 128);
    sm90::fence_regs(o_acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      sm90::wgmma_m64n256k16_ss<0, 1>(o_acc, sm90::desc_add(desc_p, 32 * kk),
                                      sm90::desc_add(desc_v, 2048 * kk), 1);
    sm90::wgmma_commit();
  };
  auto scale_o = [&](const float (&c)[2]) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o_acc[4 * j + 0] *= c[0];
      o_acc[4 * j + 1] *= c[0];
      o_acc[4 * j + 2] *= c[1];
      o_acc[4 * j + 3] *= c[1];
    }
  };

  float m_r[2] = {neg_inf(), neg_inf()};  // running max of the raw scores
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  if (wgi == 0) {
    float sc[kBN / 2];  // S, then p, of a tile
    const uint64_t desc_q = sm90::desc_sw128(sm.q);
    const uint64_t desc_k = sm90::desc_sw128(sm.k);
    // S = Q K^T of tile `it`: 32 k16 steps, 4 in each 64-column atom
    auto issue_s = [&](int it) {
      sm90::mbar_wait(&sm.k_full, it & 1);
      // the 64 descriptors are two adds each: made here, not kept in
      // registers across the loop
      uint64_t dq = desc_q, dk = desc_k;
      asm volatile("" : "+l"(dq), "+l"(dk));
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t qo = (kk >> 2) * (kBM * 128) + 32 * (kk & 3);
        const uint32_t ko = (kk >> 2) * (kBN * 128) + 32 * (kk & 3);
        sm90::wgmma_m64n64k16_ss<0, 0>(sc, sm90::desc_add(dq, qo),
                                       sm90::desc_add(dk, ko), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // the online softmax of tile `it` in sc (sc[4j + e]: row row0 + 8 (e /
    // 2), key 8j + 2t + (e % 2) of the tile), in the exp2 domain: p in
    // place, l rescaled and added to; corr rescales O to the new max
    auto softmax = [&](int it, float (&corr)[2]) {
      const int n0 = it * kBN;
      if (n0 + kBN > p.sk) {  // keys past sk
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
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m_r[r] - mx[r]) * sl2);  // 0 on the first tile
        m_r[r] = mx[r];
        ms[r] = mx[r] * sl2;
        l_r[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = ex2(fmaf(sc[4 * j + e], sl2, -ms[e >> 1]));
          sc[4 * j + e] = pv;
          // l sums the bf16-rounded p that the PV product reads
          l_r[e >> 1] += round_bf16(pv);
        }
    };
    // tile it's P into its buffer (128-byte swizzled rows of 64 keys) and
    // its corr, for both warpgroups
    auto write_p = [&](int it, const float (&corr)[2]) {
      sm90::mbar_wait(&sm.p_empty[it & 1], ((it >> 1) & 1) ^ 1);
      uint32_t* pt = reinterpret_cast<uint32_t*>(sm.p[it & 1]);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          pt[row * 32 + ((j ^ (row & 7)) << 2) + t] =
              pack_bf16(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
        }
      if (t == 0) {
        sm.corr[it & 1][row0] = corr[0];
        sm.corr[it & 1][row0 + 8] = corr[1];
      }
      sm90::fence_async_smem();
      sm90::mbar_arrive(&sm.p_full[it & 1]);
    };

    sm90::mbar_wait(&sm.q_full, 0);
    float corr[2];
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    release(&sm.k_empty);
    softmax(0, corr);
    write_p(0, corr);
    // tile it + 1's S runs on the tensor cores beside tile it's PV (both
    // warpgroups'), and its softmax waits only for the S
    for (int it = 0; it + 1 < n_tiles; ++it) {
      sm90::mbar_wait(&sm.p_full[it & 1], (it >> 1) & 1);
      issue_s(it + 1);
      issue_pv(it);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      release(&sm.k_empty);
      softmax(it + 1, corr);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o_acc);
      sm90::fence_regs(sc);
      release(&sm.v_empty);
      if (lane == 0) sm90::mbar_arrive(&sm.p_empty[it & 1]);
      scale_o(corr);
      write_p(it + 1, corr);
    }
    const int last = n_tiles - 1;
    sm90::mbar_wait(&sm.p_full[last & 1], (last >> 1) & 1);
    issue_pv(last);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o_acc);
    release(&sm.v_empty);
    if (lane == 0) sm90::mbar_arrive(&sm.p_empty[last & 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    if (t == 0) {  // every row has a valid key 0: l >= 1
      sm.inv[row0] = 1.f / l_r[0];
      sm.inv[row0 + 8] = 1.f / l_r[1];
    }
  } else {
    for (int it = 0; it < n_tiles; ++it) {
      sm90::mbar_wait(&sm.p_full[it & 1], (it >> 1) & 1);
      const float c[2] = {sm.corr[it & 1][row0], sm.corr[it & 1][row0 + 8]};
      scale_o(c);
      issue_pv(it);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o_acc);
      release(&sm.v_empty);
      if (lane == 0) sm90::mbar_arrive(&sm.p_empty[it & 1]);
    }
  }
  sm90::bar_sync(1, 256);  // 1 / l is in place; Q is consumed
  const float inv[2] = {sm.inv[row0], sm.inv[row0 + 8]};
  // this warpgroup's 256 columns through its half of the Q tile (4 atoms,
  // the same swizzle), then out in 16-byte rows
  uint32_t* stage =
      reinterpret_cast<uint32_t*>(sm.q + wgi * (kHalf * kBM * 64));
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      stage[(j >> 3) * (kBM * 32) + row * 32 + (((j & 7) ^ (row & 7)) << 2) +
            t] = pack_bf16(o_acc[4 * j + 2 * r] * inv[r],
                           o_acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  sm90::bar_sync(2 + wgi, 128);
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh + wgi * (kHalf * 64);
  const uint4* st4 = reinterpret_cast<const uint4*>(stage);
  const int tw = tid & 127;
#pragma unroll
  for (int i = 0; i < kHalf * kBM * 8 / 128; ++i) {
    const int idx = tw + 128 * i;
    const int a = idx / (kBM * 8), row = (idx / 8) % kBM, c = idx % 8;
    if (m0 + row < p.sq)
      *reinterpret_cast<uint4*>(ob + (long long)(m0 + row) * p.o_ss + 64 * a +
                                8 * c) =
          st4[a * (kBM * 8) + row * 8 + (c ^ (row & 7))];
  }
  if (wgi == 0 && p.lse != nullptr && t == 0) {
    float* lse = p.lse + (long long)bh * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = m0 + row0 + 8 * r;
      if (qrow < p.sq)
        lse[qrow] = (m_r[r] * sl2 + log2f(l_r[r])) * kLn2;
    }
  }
  sm90::cluster_sync();  // the peer's arrivals on this block have landed
}

int launch(const Params& p, int batch, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, kD, p.q_sb, p.q_ss, p.q_sh, p.heads, p.sq,
                     batch, kBM);
  if (!err)
    err = make_map(&tk, p.k, kD, p.k_sb, p.k_ss, p.k_sh, p.heads, p.sk,
                   batch, kBN);
  if (!err)
    err = make_map(&tv, p.v, kD, p.v_sb, p.v_ss, p.v_sh, p.heads, p.sk,
                   batch, kBN);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_d512, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  // query tiles in pairs (a cluster); a tile past sq loads its half of
  // the pair's K/V and stores nothing
  const int tiles = (p.sq + kBM - 1) / kBM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + kPair - 1) / kPair * kPair, batch * p.heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute pair;
  pair.id = cudaLaunchAttributeClusterDimension;
  pair.val.clusterDim.x = kPair;
  pair.val.clusterDim.y = 1;
  pair.val.clusterDim.z = 1;
  cfg.attrs = &pair;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_fwd_d512, p, tq, tk, tv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace wg512


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
// p (#3, #4, #5), else the unrounded p (#1, #2); head dim 512 (#3, #4) takes
// the rounded sum only. Returns a cudaError_t code (0 on success).
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
    return ones ? wg512::launch(p, batch, s) : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}

// Keys a tile of the forward kernel at head_dim, 0 for a head dim it does
// not take: where its running max moves, so where the rounded-p normalizer
// rounds p.
extern "C" int tc_flash_key_tile(int head_dim) {
  return head_dim == 64 ? wg::kBN : head_dim == 512 ? wg512::kBN : 0;
}
