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
// What bounds it on the H100: q is read and the output written once (4
// bytes an element), with the heads' K/V, against 4 (77 + 16) / 4 ~ 93
// products an element: well under the card's ~295 FLOP a byte, so the
// bytes do (0.032 ms at the ds1 shape, B = 32, Sq = 2560, C = 320). The
// design reads each (b, h)'s K/V about once and streams q:
//   * the query rows of a (b, h) are 64-row tiles; each head's (b, tile)
//     index, tiles fastest, is cut into contiguous ranges, one a persistent
//     block (ops/cross_attention.plan), so a block walks the tiles of one
//     (b, h) before the next and loads that head's K/V only when (b, h)
//     changes; blocks h = 0 .. heads - 1 of a range run side by side on the
//     same query rows, so the heads' 128-byte slices of a row are read
//     (and o's written) together (a range over (b, h, tile) that kept each
//     block on its own rows ran at 1.3 TB/s);
//   * one producer thread: K/V by TMA (3-D maps over kt, vt, ki, vi; key
//     tiles of 80 text and 16 image rows, the rows past Lt or Li arrive as
//     zeros and are masked) into one of two slots, the next (b, h)'s while
//     the consumers finish the last, and the q tiles through an mbarrier
//     ring (128-byte swizzle);
//   * four consumer warps, 16 query rows each: q's A fragments by ldmatrix,
//     read once for both branches; K's B fragments by ldmatrix and V's by
//     ldmatrix.trans from the swizzled tiles (no transpose in shared
//     memory); mma.sync m16n8k16 with the scores in registers, reused as
//     the A operand of the PV product; an online softmax across the key
//     tiles (one tile a branch at the UNet's shapes, so no rescale runs);
//     acc / l by one rounded reciprocal a row and an fma correction
//     (correctly rounded, as a division, in three instructions an element);
//     the combine into the warp's swizzled staging tile, out by TMA store;
//   * contexts whose key tiles do not fit twice beside the ring (the JAX
//     envelope admits up to 1024 tokens a branch) take the streamed
//     branch: every q tile's key tiles come through a second ring, with
//     the same tiles and so the same rescales.
// s_ip is a value, or one float in device memory (a learnable gate costs no
// host sync); either way a call is one launch.
//
// What paces it in practice (H100, PERF.md): the consumers' instruction
// issue. A warp's 16 rows of a resident tile take ~1100 instructions (96
// mma, 52 ldmatrix, the fp32 softmax of 96 keys, two divisions and the
// combine), and the time follows their count; with q only loaded and o
// stored the kernel takes about 0.043 ms at ds1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {
namespace dual {

constexpr int kD = 64;                 // head dim
constexpr int kWarps = 4;              // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kBlockM = 16 * kWarps;   // query rows a tile
constexpr int kRow = kD * 2;           // bytes of a tile row
constexpr int kQTile = kBlockM * kRow;
constexpr int kTextTile = 80;          // keys a text tile (77, padded)
constexpr int kImageTile = 16;         // keys an image tile
constexpr int kText = kTextTile * kRow;  // bytes of a text K (or V) tile
constexpr int kImage = kImageTile * kRow;
constexpr int kStreamSlot = 2 * kText;  // a streamed slot: one K and V tile

struct Params {
  const float* s_ip;  // the gate in device memory, or null: s_ip_value
  float s_ip_value;
  int heads, lt, li;
  int qtiles;         // 64-row tiles a (b, h)
  int span;           // batch qtiles: the tiles of a head
  int blocks;         // blocks a head (the grid is heads blocks)
  int text_tiles, image_tiles;  // key tiles a branch
  int resident;       // K/V of a (b, h) held in a slot; else streamed
  int qstages, kvslots;
  int slot;           // bytes of a K/V slot
  float scale_log2;   // softmax scale * log2(e)
};

// a K/V slot's tiles: resident [Kt tiles][Vt tiles][Ki tiles][Vi tiles];
// streamed [K][V] of one tile
struct Tiles {
  int kt, vt, ki, vi;  // offsets of tile 0 of each
};

__device__ __forceinline__ Tiles resident_tiles(const Params& p) {
  const int t = p.text_tiles * kText, i = p.image_tiles * kImage;
  return {0, t, 2 * t, 2 * t + i};
}

// a position in a ring of n stages: the stage, and the parity of the phase
// that fills it this time round, stepped without a division
struct RingPos {
  int n, stage = 0, phase = 0, turns = 0;
  __device__ __forceinline__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
      ++turns;
    }
  }
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// 2^x for x <= 0 (the exponent of a softmax term), flushing results below
// 2^-126 to 0: they cannot move a sum of terms of which one is 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

// op over the 2 NT fragment values of row half r (elements 2 r, 2 r + 1 of
// each n8 tile) as a tree, so the reduction is log2(2 NT) deep
template <int NT, class Op>
__device__ __forceinline__ float tree(const float (&s)[NT][4], int r, Op op) {
  float v[2 * NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    v[2 * j] = s[j][2 * r];
    v[2 * j + 1] = s[j][2 * r + 1];
  }
#pragma unroll
  for (int w = 1; w < 2 * NT; w *= 2)
#pragma unroll
    for (int i = 0; i + w < 2 * NT; i += 2 * w) v[i] = op(v[i], v[i + w]);
  return v[0];
}

// One key tile of BN keys (K rows at ks, V rows at vs, swizzled) for this
// warp's 16 query rows: the online softmax in the exp2 domain over the
// tile's first `valid` keys, acc += bf16(p) V. kFirst: the branch's first
// tile (m -inf and l 0 before it; acc set to 0 here), so no rescale runs.
template <int BN, bool kFirst>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[kD / 16][4],
                                            const unsigned char* ks,
                                            const unsigned char* vs,
                                            int valid, float scale_log2,
                                            float (&acc)[kD / 8][4],
                                            float (&m_r)[2], float (&l_r)[2]) {
  constexpr int NT = BN / 8;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // ldmatrix rows: K's B fragments (lane % 8) + 8 (lane / 16), chunk + (lane
  // / 8) % 2; V's .trans B fragments (lane % 8) + 8 ((lane / 8) % 2), chunk
  // + lane / 16. A row group 16 rows on keeps the swizzle (row % 8), so it
  // is the same address 2048 bytes on, an offset in the instruction.
  const int l7 = lane & 7;
  const uint32_t kb =
      sm90::smem_u32(ks) + (l7 + ((lane >> 4) << 3)) * kRow;
  const uint32_t vb =
      sm90::smem_u32(vs) + (l7 + (((lane >> 3) & 1) << 3)) * kRow;
  const int cb = (lane >> 3) & 1, cv = lane >> 4;

  // scores: each k16 step's K fragments loaded before its products
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t a = kb + (((2 * kk + cb) ^ l7) << 4);
    uint32_t kf[NT / 2][4];
    static_for<NT / 2>([&](auto i) {
      constexpr int np = decltype(i)::value;
      ldsm_x4<np * 2048>(kf[np], a);
    });
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma_16816(s[2 * np], qa[kk], kf[np][0], kf[np][1]);
      mma_16816(s[2 * np + 1], qa[kk], kf[np][2], kf[np][3]);
    }
  }

  // softmax in the exp2 domain; keys past `valid` (padding) masked: none
  // in a full tile, only the last n8 tile's where it alone is short (77
  // text tokens), else every n8 tile's
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
  if (valid < BN) {
    if (valid > BN - 8) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (BN - 8 + 2 * t + (e & 1) >= valid) s[NT - 1][e] = neg_inf();
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * t + (e & 1) >= valid) s[j][e] = neg_inf();
    }
  }
  float mx[2] = {tree<NT>(s, 0, MaxOp()), tree<NT>(s, 1, MaxOp())};
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], m_r[r]);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mu[r] = mx[r] == neg_inf() ? 0.f : mx[r];
    if (!kFirst) {
      const float corr = exp2_ftz(m_r[r] - mu[r]);
      l_r[r] *= corr;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
    m_r[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2_ftz(s[j][e] - mu[e >> 1]);
  // l sums the unrounded p
  l_r[0] += tree<NT>(s, 0, AddOp());
  l_r[1] += tree<NT>(s, 1, AddOp());
  // acc += bf16(P) V, each key step's V fragments loaded before its
  // products; acc starts here on the first tile (not live before)
  if (kFirst) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] =
        acc[j][3] = 0.f;
  }
  static_for<BN / 16>([&](auto i) {
    constexpr int kk = decltype(i)::value;
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    uint32_t vf[kD / 16][4];
#pragma unroll
    for (int jp = 0; jp < kD / 16; ++jp)
      ldsm_x4<kk * 2048, true>(vf[jp], vb + (((2 * jp + cv) ^ l7) << 4));
#pragma unroll
    for (int jp = 0; jp < kD / 16; ++jp) {
      mma_16816(acc[2 * jp], a, vf[jp][0], vf[jp][1]);
      mma_16816(acc[2 * jp + 1], a, vf[jp][2], vf[jp][3]);
    }
  });
}

// One branch over its key tiles (`tiles` of BN keys, tile j's K and V rows
// at kv(j)), from m = -inf and l = acc = 0; out = acc / l, correctly
// rounded without a division an element (Markstein: with r = 1 / l rounded
// once, q = acc r is within an ulp, e = acc - q l is exact by fma, and q +
// e r rounds to acc / l).
template <int BN, class KV>
__device__ __forceinline__ void branch(const uint32_t (&qa)[kD / 16][4],
                                       int tiles, int keys, float scale_log2,
                                       const KV& kv, float (&out)[kD / 8][4]) {
  float m_r[2] = {neg_inf(), neg_inf()};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sum
  const unsigned char* ks;
  const unsigned char* vs;
  kv(0, ks, vs);
  attend_tile<BN, true>(qa, ks, vs, keys, scale_log2, out, m_r, l_r);
  kv.done(0);
  for (int j = 1; j < tiles; ++j) {
    kv(j, ks, vs);
    attend_tile<BN, false>(qa, ks, vs, keys - j * BN, scale_log2, out, m_r,
                           l_r);
    kv.done(j);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const float rl = __frcp_rn(l_r[r]);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float q = __fmul_rn(out[j][e], rl);
        out[j][e] = __fmaf_rn(__fmaf_rn(-q, l_r[r], out[j][e]), rl, q);
      }
  }
}

// Where a consumer warp finds a branch's key tile j: in the resident slot,
// or (streamed) in the ring, waited for and released around its use.
struct KeyTiles {
  const unsigned char* k0;  // resident: tile 0's K and V
  const unsigned char* v0;
  int step;                 // resident: bytes from one tile to the next
  unsigned char* ring;      // streamed: the K/V ring, else null
  int slot;
  uint64_t* full;
  uint64_t* empty;
  RingPos* pos;             // streamed: the warp's place in the ring

  __device__ __forceinline__ void operator()(int j, const unsigned char*& k,
                                             const unsigned char*& v) const {
    if (ring == nullptr) {
      k = k0 + j * step;
      v = v0 + j * step;
      return;
    }
    sm90::mbar_wait(&full[pos->stage], pos->phase);
    k = ring + pos->stage * slot;
    v = k + kText;
  }
  __device__ __forceinline__ void done(int) const {
    if (ring == nullptr) return;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&empty[pos->stage]);
    pos->next();
  }
};

// Shared memory: the K/V slots (two resident, or `kvslots` streamed), the q
// ring, the consumer warps' staging tiles (16 rows each), then the barriers:
// q full and empty, K/V full and empty.
__global__ void __launch_bounds__(kThreads, 2)
dual_cross_kernel(const Params p, const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_kt,
                  const __grid_constant__ CUtensorMap tm_vt,
                  const __grid_constant__ CUtensorMap tm_ki,
                  const __grid_constant__ CUtensorMap tm_vi,
                  const __grid_constant__ CUtensorMap tm_o) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* kv = base;
  unsigned char* qring = kv + p.kvslots * p.slot;
  unsigned char* staging = qring + p.qstages * kQTile;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(staging + kWarps * 16 * kRow);
  uint64_t* q_empty = q_full + p.qstages;
  uint64_t* kv_full = q_empty + p.qstages;
  uint64_t* kv_empty = kv_full + p.kvslots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's head and its range of that head's (b, tile) index, tiles
  // fastest: blocks h, h + 1, .. of one range walk the same query rows
  const int head = blockIdx.x % p.heads, run = blockIdx.x / p.heads;
  const int lo = (int)((long long)run * p.span / p.blocks);
  const int hi = (int)((long long)(run + 1) * p.span / p.blocks);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.qstages; ++s) {
      sm90::mbar_init(&q_full[s], 1);
      sm90::mbar_init(&q_empty[s], kWarps);
    }
    for (int s = 0; s < p.kvslots; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], kWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    if (lane != 0) return;
    int prev = -1, loads = 0, bq = lo / p.qtiles, qt = lo % p.qtiles;
    RingPos qr{p.qstages}, kr{p.kvslots};
    for (int f = lo; f < hi; ++f, ++qt) {
      if (qt == p.qtiles) {
        qt = 0;
        ++bq;
      }
      const int bh = bq * p.heads + head;
      if (p.resident && bh != prev) {
        // the (b, h) whose K/V the slot takes, once the consumers have
        // left the slot's last one
        const int src = bh;
        const int slot = loads & 1;
        if (loads >= 2)
          sm90::mbar_wait(&kv_empty[slot], ((loads >> 1) - 1) & 1);
        unsigned char* sl = kv + slot * p.slot;
        const int c0 = (src % p.heads) * kD, b = src / p.heads;
        sm90::mbar_expect_tx(&kv_full[slot], p.slot);
        const Tiles o = resident_tiles(p);
        for (int j = 0; j < p.text_tiles; ++j) {
          sm90::tma_load_3d(sl + o.kt + j * kText, &tm_kt, &kv_full[slot], c0,
                            j * kTextTile, b);
          sm90::tma_load_3d(sl + o.vt + j * kText, &tm_vt, &kv_full[slot], c0,
                            j * kTextTile, b);
        }
        for (int j = 0; j < p.image_tiles; ++j) {
          sm90::tma_load_3d(sl + o.ki + j * kImage, &tm_ki, &kv_full[slot],
                            c0, j * kImageTile, b);
          sm90::tma_load_3d(sl + o.vi + j * kImage, &tm_vi, &kv_full[slot],
                            c0, j * kImageTile, b);
        }
        ++loads;
        prev = bh;
      }
      const int b = bq, c0 = head * kD;
      const int s = qr.stage;
      if (qr.turns > 0) sm90::mbar_wait(&q_empty[s], qr.phase ^ 1);
      sm90::mbar_expect_tx(&q_full[s], kQTile);
      sm90::tma_load_3d(qring + s * kQTile, &tm_q, &q_full[s], c0,
                        qt * kBlockM, b);
      qr.next();
      if (p.resident) continue;
      // streamed: the q tile's key tiles, text then image, through the ring
      for (int j = 0; j < p.text_tiles + p.image_tiles; ++j, kr.next()) {
        const int sl = kr.stage;
        if (kr.turns > 0) sm90::mbar_wait(&kv_empty[sl], kr.phase ^ 1);
        unsigned char* d = kv + sl * p.slot;
        const bool text = j < p.text_tiles;
        sm90::mbar_expect_tx(&kv_full[sl], text ? 2 * kText : 2 * kImage);
        if (text) {
          sm90::tma_load_3d(d, &tm_kt, &kv_full[sl], c0, j * kTextTile, b);
          sm90::tma_load_3d(d + kText, &tm_vt, &kv_full[sl], c0,
                            j * kTextTile, b);
        } else {
          const int r = (j - p.text_tiles) * kImageTile;
          sm90::tma_load_3d(d, &tm_ki, &kv_full[sl], c0, r, b);
          sm90::tma_load_3d(d + kText, &tm_vi, &kv_full[sl], c0, r, b);
        }
      }
    }
    return;
  }

  const float si = p.s_ip != nullptr ? __ldg(p.s_ip) : p.s_ip_value;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (lane & 7) + (((lane >> 3) & 1) << 3), ca = lane >> 4;
  unsigned char* stg = staging + warp * 16 * kRow;
  const Tiles rt = resident_tiles(p);
  int prev = -1, loads = 0, bq = lo / p.qtiles, qt = lo % p.qtiles;
  RingPos qr{p.qstages}, kr{p.kvslots};
  for (int f = lo; f < hi; ++f, ++qt) {
    if (qt == p.qtiles) {
      qt = 0;
      ++bq;
    }
    const int bh = bq * p.heads + head;
    if (p.resident && bh != prev) {
      __syncwarp();
      if (loads > 0 && lane == 0)
        sm90::mbar_arrive(&kv_empty[(loads - 1) & 1]);
      sm90::mbar_wait(&kv_full[loads & 1], (loads >> 1) & 1);
      ++loads;
      prev = bh;
    }
    const unsigned char* slot = kv + ((loads - 1) & 1) * p.slot;
    // this warp's q rows as A fragments, read once for both branches
    const int s = qr.stage;
    sm90::mbar_wait(&q_full[s], qr.phase);
    uint32_t qa[kD / 16][4];
    const unsigned char* qs = qring + s * kQTile;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldmatrix_x4(qa[kk], reinterpret_cast<const bf16*>(
                              qs + sw128(16 * warp + ra, 2 * kk + ca)));
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&q_empty[s]);
    qr.next();

    // the text and the image branch
    float ot[kD / 8][4], oi[kD / 8][4];
    KeyTiles kt{slot + rt.kt, slot + rt.vt, kText, nullptr, p.slot,
                kv_full, kv_empty, &kr};
    if (!p.resident) kt.ring = kv;
    branch<kTextTile>(qa, p.text_tiles, p.lt, p.scale_log2, kt, ot);
    KeyTiles ktimg = kt;
    ktimg.k0 = slot + rt.ki;
    ktimg.v0 = slot + rt.vi;
    ktimg.step = kImage;
    branch<kImageTile>(qa, p.image_tiles, p.li, p.scale_log2, ktimg, oi);

    // the combine in fp32 (no fused multiply-add: the TPU kernel's and the
    // plain version's separate product and sum), one rounding to bf16, into
    // the staging tile once the previous tile's store has read it
    if (lane == 0) sm90::bulk_wait_read<0>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = __fadd_rn(ot[j][e], __fmul_rn(si, oi[j][e]));
      const uint32_t px = sm90::smem_u32(stg) + sw128(g, j) + 4 * t;
      sts32(px, pack_bf16(y[0], y[1]));
      sts32(px + 8 * kRow, pack_bf16(y[2], y[3]));
    }
    sm90::fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      sm90::tma_store_3d(&tm_o, stg, head * kD, qt * kBlockM + 16 * warp,
                         bq);
      sm90::bulk_commit();
    }
  }
  if (lane == 0) sm90::bulk_wait<0>();  // the last store is out
}

// a (batch, rows, heads * 64) operand at element strides (sb, ss) viewed as
// (C, rows, batch), in boxes of {64, box_rows, 1}
int make_map(CUtensorMap* map, const void* base, int batch, int rows, int c,
             long long sb, long long ss, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)c, (uint64_t)rows, (uint64_t)batch};
  const uint64_t strides[2] = {(uint64_t)ss * 2, (uint64_t)sb * 2};
  const uint32_t box[3] = {(uint32_t)kD, (uint32_t)box_rows, 1u};
  return sm90_host::make_map(map, base, 3, dims, strides, box);
}

}  // namespace dual
}  // namespace

// q, o: bf16 (batch, sq, heads * 64); kt, vt: (batch, lt, heads * 64); ki,
// vi: (batch, li, heads * 64); each with unit stride on the channels and
// the given element strides for the batch and the rows (multiples of 8),
// 16-byte aligned. s_ip: one fp32 value in device memory, or null and the
// value s_ip_value; scale_log2: the softmax scale times log2(e). The plan
// (ops/cross_attention.plan): `resident` (K/V of a (b, h) in one of two
// slots) or streamed through `kvslots` slots, `qstages` q stages, `grid`
// persistent blocks. Returns a cudaError_t code.
extern "C" int tc_dual_cross_attention(
    const void* q, const void* kt, const void* vt, const void* ki,
    const void* vi, const float* s_ip, float s_ip_value, void* o,
    long long q_sb, long long q_ss, long long kt_sb, long long kt_ss,
    long long vt_sb, long long vt_ss, long long ki_sb, long long ki_ss,
    long long vi_sb, long long vi_ss, long long o_sb, long long o_ss,
    int batch, int heads, int sq, int lt, int li, float scale_log2,
    int resident, int qstages, int kvslots, int grid, void* stream) {
  using namespace dual;
  if (batch <= 0 || heads <= 0 || sq <= 0 || lt <= 0 || li <= 0 ||
      batch > 65535 || qstages < 2 || grid < 1 || kvslots < 2 ||
      (resident && kvslots != 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.s_ip = s_ip;
  p.s_ip_value = s_ip_value;
  p.heads = heads;
  p.lt = lt;
  p.li = li;
  p.qtiles = (sq + kBlockM - 1) / kBlockM;
  const long long span = (long long)batch * p.qtiles;
  if (grid % heads || grid / heads > span || span * heads >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  p.span = (int)span;
  p.blocks = grid / heads;
  p.text_tiles = (lt + kTextTile - 1) / kTextTile;
  p.image_tiles = (li + kImageTile - 1) / kImageTile;
  p.resident = resident;
  p.qstages = qstages;
  p.kvslots = kvslots;
  p.slot = resident ? 2 * (p.text_tiles * kText + p.image_tiles * kImage)
                    : kStreamSlot;
  p.scale_log2 = scale_log2;
  const int smem = kvslots * p.slot + qstages * kQTile + kWarps * 16 * kRow +
                   2 * (qstages + kvslots) * 8 + 1024;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int c = heads * kD;
  CUtensorMap m[6];
  int err = make_map(&m[0], q, batch, sq, c, q_sb, q_ss, kBlockM);
  if (!err) err = make_map(&m[1], kt, batch, lt, c, kt_sb, kt_ss, kTextTile);
  if (!err) err = make_map(&m[2], vt, batch, lt, c, vt_sb, vt_ss, kTextTile);
  if (!err) err = make_map(&m[3], ki, batch, li, c, ki_sb, ki_ss, kImageTile);
  if (!err) err = make_map(&m[4], vi, batch, li, c, vi_sb, vi_ss, kImageTile);
  if (!err) err = make_map(&m[5], o, batch, sq, c, o_sb, o_ss, 16);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dual_cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dual_cross_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p, m[0], m[1], m[2], m[3], m[4], m[5]);
  return (int)cudaGetLastError();
}

// Blocks of the kernel an SM holds with `smem` bytes of dynamic shared
// memory (the plan's assumption, read back by utils/breakdown.py), or -1.
extern "C" int tc_dual_blocks_per_sm(int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(dual::dual_cross_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, dual::dual_cross_kernel, dual::kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}
