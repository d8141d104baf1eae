// GroupNorm-affine + SiLU + 3x3 SAME convolution for Hopper (sm_90a), with
// the bias / residual / statistics epilogue, bf16 in and out:
//
//   z     = silu(bf16(x * A + B))           (the "ref" cast point: the fp32
//                                            affine rounds to bf16, then an
//                                            fp32 SiLU rounds once more)
//   y     = conv3x3(z) + bias + residual     (fp32, rounded once to bf16)
//   stats = per-image, per-channel fp32 sums of y and y^2 (of the rounded y)
//
// The halo outside the image contributes 0: the zero of z, not silu(B).
//
// Replaces the TPU kernels tooncrafter_tpu/ops/winograd.py::
// winograd_gn_silu_conv3x3 (F(2x2,3x3) Winograd), its F(2x4) twin
// winograd24_gn_silu_conv3x3 and, with the prologue at the fp32 cast point
// (round_first 0: one rounding, after the SiLU), the im2col kernel
// tooncrafter_tpu/ops/spatial_conv.py::_pallas_fused_conv. This is a direct
// implicit GEMM instead: M = the pixels of one image, N = Cout, K = 9 * Cin
// (per 64-channel chunk, the nine taps). The function is the same; the
// Winograd transform was the TPU's way to spend fewer MXU multiplies, and
// it rounds its transformed tiles to bf16, which a direct product does not.
//
// What bounds it on the H100: 2 * 9 * Cin operations per output element
// against ~4 bytes in and out per pixel and channel: at Cin >= 320 far above
// the card's ~295 operations per byte, so the tensor cores bound it, and
// only wgmma reaches their rate. What the fused form saves: the normalised,
// activated z never reaches device memory, and the residual add and the
// next norm's statistics ride the epilogue.
//
// Design (one block per (pixel tile of BM = 64 or 128, Cout tile of BN =
// 160, image); every UNet width is a multiple of 160):
//   * BM / 64 consumer warpgroups, each a 64-row wgmma tile, its fp32
//     accumulator in registers; B (the weight, (Cout, 9, Cin), K-major)
//     from shared memory through a descriptor, A from registers;
//   * the weight tile of each (chunk, tap) is brought by TMA (128-byte
//     swizzle) into a ring of 2-4 stages on mbarriers by one producer
//     thread, up to the ring's depth ahead of the products;
//   * each 64-channel chunk's halo (BM + 2W + 2 source pixels, rows padded
//     to 144 bytes so ldmatrix reads them conflict-free) is copied by seven
//     helper warps with cp.async (all of a chunk's loads in flight at once,
//     two chunks ahead of the activation) into a ring of up to four
//     buffers and activated there in place, once, with the image's affine
//     staged in shared memory; so the next chunks land and are activated
//     while the current chunk's nine taps run (the helpers' latency, not
//     the products, set the pace with fewer buffers). At 128-pixel tiles
//     the two blocks of a cluster (two Cout tiles) split the halo's rows
//     and write each activated row to both, halving the activation, the
//     kernel's pace-setter. setmaxnreg moves the helpers' registers to
//     the consumers;
//   * each tap reads the halo shifted by dy * W + dx with ldmatrix into
//     the A fragments and zeroes the rows whose source lies past the
//     image's left or right edge (in the linear pixel order those are
//     pixels of the neighbouring row; sources above or below the image are
//     the halo's zero rows). A shared-memory descriptor cannot start a
//     view at any row of a swizzled tile; a plain (unswizzled) tile can,
//     but the products ran slower that way (PERF.md). The next
//     tap's fragments load while the current tap's products run.
// The sums of the epilogue are reduced over each warp's rows by shuffles,
// then over the warps in a fixed order: deterministic, no atomics.

#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBN = 160;        // output channels a block
constexpr int kKC = 64;         // input channels a chunk
constexpr int kHaloLd = 72;     // halo row stride, elements (144 bytes)
constexpr int kMaxWidth = 256;  // image width cap: the halo's size
constexpr int kMaxSmem = 232448;
constexpr int kActThreads = 224;  // seven helper warps activate the halo

struct Params {
  const bf16* x;       // (N, H, W, cin)
  const float* a;      // (N, cin) folded affine
  const float* b;
  const bf16* bias;    // (cout)
  const bf16* res;     // like out, or null
  bf16* out;           // (N, H * W, cout)
  float* s1;           // (N, n_mtiles, cout), or null: no sums
  float* s2;
  int h, wd, cin, cout, silu, n_mtiles;
  int stages;          // the weight ring's depth
  int bufs;            // halo buffers, 2-4
  int halo_rows;       // BM + 2 W + 2
};

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 16 bytes global -> shared, asynchronously (cp.async)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// v * sigmoid(v) with the approximate exponential and reciprocal (a few
// fp32 ulps, far below the bf16 rounding that follows; the IEEE-rounded
// reciprocal, or __expf's range fix-up, cost instructions the prologue,
// which sets the kernel's pace, cannot spare)
__device__ __forceinline__ float fast_silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

// 16 bytes from / to shared memory at a shared-window address
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// z for eight channels: the affine (fp32), for the "ref" cast point rounded
// to bf16 first, the SiLU, one rounding to bf16
template <bool kRoundFirst>
__device__ __forceinline__ uint4 activate8(uint4 v, const float (&as)[8],
                                           const float (&bs)[8], int silu) {
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[j]));
    float z0 = x.x * as[2 * j] + bs[2 * j];
    float z1 = x.y * as[2 * j + 1] + bs[2 * j + 1];
    if (kRoundFirst) {
      z0 = round_bf16(z0);
      z1 = round_bf16(z1);
    }
    if (silu) {
      z0 = fast_silu(z0);
      z1 = fast_silu(z1);
    }
    u[j] = pack_bf16(z0, z1);
  }
  return v;
}

// Shared memory, from a 1024-byte aligned base: the weight ring
// [stages][kBN][64] (swizzled by TMA), the halo buffers
// [bufs][halo_rows][kHaloLd], the image's affine [2][cin], then the
// barriers.
struct Smem {
  bf16* w;
  bf16* halo;
  float* aff;
  uint64_t* w_full;
  uint64_t* w_empty;
  uint64_t* h_full;   // [bufs]
  uint64_t* h_empty;  // [bufs]
  __device__ Smem(unsigned char* raw, const Params& p) {
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    w = reinterpret_cast<bf16*>(base);
    halo = w + p.stages * kBN * kKC;
    aff = reinterpret_cast<float*>(halo + p.bufs * p.halo_rows * kHaloLd);
    w_full = reinterpret_cast<uint64_t*>(aff + 2 * p.cin);
    w_empty = w_full + p.stages;
    h_full = w_empty + p.stages;
    h_empty = h_full + p.bufs;
  }
};

constexpr int kStageBytes = kBN * kKC * 2;

// NWG consumer warpgroups (BM = 64 NWG pixels), then two warpgroups of
// helpers: warp 0 issues the weight TMA loads, warps 1-7 the halo's. At
// 128 pixels (kPair) the two blocks of a cluster (two Cout tiles of one
// pixel tile) share the halo: each copies and activates half of its rows
// and writes them to both. At 64 the halo is small, and the pair's
// traffic and waits cost more than they save (PERF.md).
template <int NWG, bool kRoundFirst>
__global__ void __launch_bounds__((NWG + 2) * 128, 1)
conv_kernel(const Params p, const __grid_constant__ CUtensorMap tm_w) {
  constexpr bool kPair = NWG == 2;
  constexpr int kBlocks = kPair ? 2 : 1;  // blocks sharing the halo
  constexpr int BM = 64 * NWG;
  // the registers a consumer thread may hold once the helpers drop to 80
  // (the helpers' activation needs that many to keep several elements'
  // exp2 / rcp chains in flight)
  constexpr int kConsumerRegs = NWG == 2 ? 176 : 232;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw, p);
  const int tid = threadIdx.x;
  const int W = p.wd, hw = p.h * W, R = p.halo_rows;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN, f = blockIdx.z;
  const int chunks = (p.cin + kKC - 1) / kKC;
  const uint32_t peer = sm90::cluster_rank() ^ 1;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(&sm.w_full[s], 1);
      sm90::mbar_init(&sm.w_empty[s], NWG * 4);  // one per consumer warp
    }
    for (int i = 0; i < p.bufs; ++i) {  // both blocks' helpers / consumers
      sm90::mbar_init(&sm.h_full[i], kBlocks * kActThreads);
      sm90::mbar_init(&sm.h_empty[i], kBlocks * NWG * 4);
    }
    sm90::mbar_fence_init();
  }
  sm90::cluster_sync();  // the peer's barriers are set up too

  if (tid >= NWG * 128) {  // the helpers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    if (tid == NWG * 128) {  // the weight producer
      const int steps = 9 * chunks;
      for (int s = 0; s < steps; ++s) {
        const int st = s % p.stages;
        const int c = s / 9, tap = s - 9 * c;
        sm90::mbar_wait(&sm.w_empty[st], ((s / p.stages) & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.w_full[st], kStageBytes);
        sm90::tma_load_3d(sm.w + st * kBN * kKC, &tm_w, &sm.w_full[st],
                          c * kKC, tap, n0);
      }
    } else if (tid >= NWG * 128 + 32) {  // the halo: copy, activate in place
      const int at = tid - (NWG * 128 + 32);
      const int cg = at & 7;  // this thread's 8-channel group
      const int base = m0 - W - 1;
      // this block's share of the halo rows; the peer does the rest
      const int share = (R + kBlocks - 1) / kBlocks;
      const int r0 = kPair ? (peer ^ 1) * share : 0, r1 = min(R, r0 + share);
      const bf16* xf = p.x + (long long)f * hw * p.cin;
      // chunk c's loads, all in flight at once, into its buffer (once the
      // consumers of both blocks are done with the chunk that held it); one
      // cp.async group
      auto copy = [&](int c) {
        if (c < chunks) {
          const int buf = c % p.bufs, ch = c * kKC + cg * 8;
          bf16* hb = sm.halo + buf * R * kHaloLd + cg * 8;
          sm90::mbar_wait<true>(&sm.h_empty[buf], ((c / p.bufs) & 1) ^ 1);
          for (int row = r0 + (at >> 3); row < r1; row += kActThreads / 8) {
            const int src = base + row;
            if (ch < p.cin && src >= 0 && src < hw)
              cp_async16(hb + row * kHaloLd, xf + (long long)src * p.cin + ch);
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      // the loads run `ahead` chunks before the activation: as far as the
      // ring allows without waiting for the chunk being computed
      const int ahead = p.bufs - 2;
      for (int c = 0; c < ahead; ++c) copy(c);
      for (int i = at; i < 2 * p.cin; i += kActThreads)  // the affine
        sm.aff[i] = (i < p.cin ? p.a : p.b)[(long long)f * p.cin +
                                            i % p.cin];
      asm volatile("bar.sync 2, %0;\n" ::"n"(kActThreads) : "memory");
      for (int c = 0; c < chunks; ++c) {
        copy(c + ahead);  // chunk c's group is then `ahead` from the last
        if (ahead == 2)
          asm volatile("cp.async.wait_group 2;\n" ::: "memory");
        else if (ahead == 1)
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        const int buf = c % p.bufs, ch = c * kKC + cg * 8;
        const bool cv = ch < p.cin;
        float as[8], bs[8];
#pragma unroll
        for (int j = 0; j < 8; j += 4) {
          const uint4 a4 = lds128(sm90::smem_u32(sm.aff + ch + j));
          const uint4 b4 = lds128(sm90::smem_u32(sm.aff + p.cin + ch + j));
          const uint32_t av[4] = {a4.x, a4.y, a4.z, a4.w};
          const uint32_t bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            as[j + i] = __uint_as_float(av[i]);
            bs[j + i] = __uint_as_float(bv[i]);
          }
        }
        bf16* hp = sm.halo + buf * R * kHaloLd + cg * 8;
        const uint32_t hb = sm90::smem_u32(hp);
        const uint32_t hr = kPair ? sm90::peer_addr(hp, peer) : 0;
        // four rows a pass, all loaded before any is stored back, so the
        // rows' dependency chains overlap; each activated row (zeros where
        // the source lies outside the image or past cin) to both blocks
        constexpr int kStep = kActThreads / 8;
        for (int row0 = r0 + (at >> 3); row0 < r1; row0 += 4 * kStep) {
          uint4 v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row0 + i * kStep, src = base + row;
            v[i] = make_uint4(0u, 0u, 0u, 0u);
            if (row < r1 && cv && src >= 0 && src < hw)
              v[i] = lds128(hb + row * kHaloLd * 2);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row0 + i * kStep, src = base + row;
            if (row < r1) {
              if (cv && src >= 0 && src < hw)
                v[i] = activate8<kRoundFirst>(v[i], as, bs, p.silu);
              sts128(hb + row * kHaloLd * 2, v[i]);
              if (kPair) sm90::st_peer128(hr + row * kHaloLd * 2, v[i]);
            }
          }
        }
        sm90::mbar_arrive(&sm.h_full[buf]);
        if (kPair)
          sm90::mbar_arrive_peer(sm90::peer_addr(&sm.h_full[buf], peer));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");

  // the consumers
  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = wgi * 64 + warp * 16;  // this warp's first tile row
  // the left / right edge bits of this thread's two fragment rows
  uint32_t edge = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pix = m0 + wrow + g + 8 * r;
    const int x = pix % W;
    edge |= (uint32_t)((x == 0) | ((x == W - 1) << 1)) << (2 * r);
  }
  const int lrow = wrow + (lane & 15), lcol = (lane >> 4) * 8;

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  uint32_t af[2][4][4];

  // one chunk's nine taps, KS k16 steps each (4, or 2 for a last chunk of
  // 32 channels), in straight-line code: no branch between the products
  auto run_chunk = [&](int c, auto ks) {
    constexpr int KS = decltype(ks)::value;
    const int buf = c % p.bufs;
    const bf16* hb = sm.halo + buf * R * kHaloLd;
    // A fragments of tap `tap` (rows shifted by dy * W + dx) into af[set]
    auto load_a = [&](int set, int tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bf16* src = hb + (lrow + W + 1 + dy * W + dx) * kHaloLd + lcol;
      uint32_t keep[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t e = edge >> (2 * r);
        keep[r] = ((dx < 0 && (e & 1)) || (dx > 0 && (e & 2))) ? 0u
                                                                : 0xffffffffu;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(af[set][kk], src + kk * 16);
        af[set][kk][0] &= keep[0];
        af[set][kk][2] &= keep[0];
        af[set][kk][1] &= keep[1];
        af[set][kk][3] &= keep[1];
      }
    };
    sm90::mbar_wait<true>(&sm.h_full[buf], (c / p.bufs) & 1);
    load_a(0, 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int s = 9 * c + tap, st = s % p.stages;
      const uint64_t desc = sm90::desc_sw128(sm.w + st * kBN * kKC);
      sm90::mbar_wait(&sm.w_full[st], (s / p.stages) & 1);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        sm90::wgmma_m64n160k16_rs<0>(acc, af[tap & 1][kk],
                                     sm90::desc_add(desc, 32 * kk), 1);
      sm90::wgmma_commit();
      if (tap > 0) {  // the previous tap's products are done
        sm90::wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) sm90::fence_regs(af[(tap - 1) & 1][kk]);
        if (lane == 0) sm90::mbar_arrive(&sm.w_empty[(s - 1) % p.stages]);
      }
      if (tap < 8) load_a((tap + 1) & 1, tap + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) sm90::fence_regs(af[0][kk]);
    if (lane == 0) {
      sm90::mbar_arrive(&sm.w_empty[(9 * c + 8) % p.stages]);
      // the chunk that will reuse the buffer, if any, waits for both blocks;
      // past the last such chunk the peer may have exited: no arrivals
      if (c + p.bufs < chunks) {
        sm90::mbar_arrive(&sm.h_empty[buf]);
        if (kPair)
          sm90::mbar_arrive_peer(sm90::peer_addr(&sm.h_empty[buf], peer));
      }
    }
  };
  for (int c = 0; c < chunks; ++c) {
    if (p.cin - c * kKC >= kKC)
      run_chunk(c, std::integral_constant<int, 4>());
    else
      run_chunk(c, std::integral_constant<int, 2>());
  }

  // epilogue: acc + bias + residual, one rounding, and the sums of the
  // rounded y over this warp's rows (lanes g == 0 hold them). The bias and
  // residual pairs are all loaded first: the stores to out would otherwise
  // order every load after the store before it.
  float* st = reinterpret_cast<float*>(sm.halo);  // [2][NWG * 4][kBN]
  const bool sums = p.s1 != nullptr;
  const int wid = wgi * 4 + warp;
  uint32_t bias2[kBN / 8], res2[kBN / 8][2];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    bias2[j] = col < p.cout ? ld32(p.bias + col) : 0u;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pix = m0 + wrow + g + 8 * r;
      res2[j][r] = p.res && col < p.cout && pix < hw
                       ? ld32(p.res + ((long long)f * hw + pix) * p.cout + col)
                       : 0u;
    }
  }
  if (sums)  // every consumer is done with the halo
    asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    float q1[2] = {0.f, 0.f}, q2[2] = {0.f, 0.f};
    if (col < p.cout) {
      const float2 c = bf2_to_f2(bias2[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pix = m0 + wrow + g + 8 * r;
        if (pix >= hw) continue;
        const long long o = ((long long)f * hw + pix) * p.cout + col;
        const float2 rv = bf2_to_f2(res2[j][r]);
        const float y0 = acc[4 * j + 2 * r] + c.x + rv.x;
        const float y1 = acc[4 * j + 2 * r + 1] + c.y + rv.y;
        const uint32_t packed = pack_bf16(y0, y1);
        *reinterpret_cast<uint32_t*>(p.out + o) = packed;
        const float2 yr = bf2_to_f2(packed);
        q1[0] += yr.x;
        q1[1] += yr.y;
        q2[0] += yr.x * yr.x;
        q2[1] += yr.y * yr.y;
      }
    }
    if (sums) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          q1[e] += __shfl_xor_sync(0xffffffffu, q1[e], o);
          q2[e] += __shfl_xor_sync(0xffffffffu, q2[e], o);
        }
        if (g == 0) {
          st[(0 * NWG * 4 + wid) * kBN + 8 * j + 2 * t4 + e] = q1[e];
          st[(1 * NWG * 4 + wid) * kBN + 8 * j + 2 * t4 + e] = q2[e];
        }
      }
    }
  }
  if (!sums) return;
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  for (int c = tid; c < kBN && n0 + c < p.cout; c += NWG * 128) {
    float r1 = 0.f, r2 = 0.f;
    for (int w = 0; w < NWG * 4; ++w) {
      r1 += st[(0 * NWG * 4 + w) * kBN + c];
      r2 += st[(1 * NWG * 4 + w) * kBN + c];
    }
    const long long o =
        ((long long)f * p.n_mtiles + blockIdx.x) * p.cout + n0 + c;
    p.s1[o] = r1;
    p.s2[o] = r2;
  }
}

template <int NWG, bool kRoundFirst>
int launch(Params q, const bf16* w, int frames, cudaStream_t stream) {
  constexpr int BM = 64 * NWG;
  q.n_mtiles = (q.h * q.wd + BM - 1) / BM;
  q.halo_rows = BM + 2 * q.wd + 2;
  // the deepest rings that fit: four halo buffers where they do (the
  // loads run two chunks ahead of the activation, which runs ahead of the
  // products), then up to four weight stages
  auto bytes = [&](int bufs, int stages) {
    return 1024 + stages * kStageBytes + bufs * q.halo_rows * kHaloLd * 2 +
           2 * q.cin * 4 + 2 * (stages + bufs) * 8;
  };
  q.bufs = 0;
  for (int b = 4; b >= 2 && q.bufs == 0; --b)
    for (int st = 4; st >= 2 && q.bufs == 0; --st)
      if (bytes(b, st) <= kMaxSmem) {
        q.bufs = b;
        q.stages = st;
      }
  if (q.bufs == 0) return (int)cudaErrorInvalidValue;
  const int smem = bytes(q.bufs, q.stages);
  // the weight (cout, 9, cin): dims innermost first, boxes of one tap's 64
  // input channels of kBN output channels
  CUtensorMap tm;
  const uint64_t dims[3] = {(uint64_t)q.cin, 9, (uint64_t)q.cout};
  const uint64_t strides[2] = {(uint64_t)q.cin * 2, (uint64_t)q.cin * 18};
  const uint32_t box[3] = {kKC, 1, kBN};
  const int err = sm90_host::make_map(&tm, w, 3, dims, strides, box);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<NWG, kRoundFirst>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // at 128 pixels, Cout tiles in pairs (a cluster); a tile past Cout
  // computes nothing that is stored but shares its half of the halo
  const int ntiles = (q.cout + kBN - 1) / kBN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q.n_mtiles, NWG == 2 ? (ntiles + 1) / 2 * 2 : ntiles,
                     frames);
  cfg.blockDim = dim3((NWG + 2) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute pair;
  pair.id = cudaLaunchAttributeClusterDimension;
  pair.val.clusterDim.x = 1;
  pair.val.clusterDim.y = 2;
  pair.val.clusterDim.z = 1;
  cfg.attrs = &pair;
  cfg.numAttrs = NWG == 2 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, conv_kernel<NWG, kRoundFirst>, q, tm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, cin), w (cout, 3, 3, cin), bias (cout), res/out (N, H, W,
// cout): contiguous bf16; a, b: fp32 (N, cin); s1, s2: fp32 (N, n_mtiles,
// cout) with n_mtiles = ceil(H * W / bm), or both null. bm is 64 or 128,
// cin % 32 == 0, cout % 8 == 0, W <= 256. round_first: the "ref" cast
// point, else the fp32 one (#15). Returns a cudaError_t code (0 on
// success).
extern "C" int tc_gn_silu_conv3x3(const void* x, const float* a, const float* b,
                                  const void* w, const void* bias,
                                  const void* res, void* out, float* s1,
                                  float* s2, int n, int h, int wd, int cin,
                                  int cout, int silu, int bm, int round_first,
                                  void* stream) {
  Params q;
  q.x = static_cast<const bf16*>(x);
  q.a = a;
  q.b = b;
  q.bias = static_cast<const bf16*>(bias);
  q.res = static_cast<const bf16*>(res);
  q.out = static_cast<bf16*>(out);
  q.s1 = s1;
  q.s2 = s2;
  q.h = h;
  q.wd = wd;
  q.cin = cin;
  q.cout = cout;
  q.silu = silu;
  if (a == nullptr || b == nullptr || (s1 == nullptr) != (s2 == nullptr) ||
      n <= 0 || n > 65535 || h <= 0 || wd <= 0 || wd > kMaxWidth ||
      cin <= 0 || cin % 32 || cin > 8192 || cout <= 0 || cout % 8)
    return (int)cudaErrorInvalidValue;
  const bf16* wt = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return round_first ? launch<2, true>(q, wt, n, s)
                       : launch<2, false>(q, wt, n, s);
  if (bm == 64)
    return round_first ? launch<1, true>(q, wt, n, s)
                       : launch<1, false>(q, wt, n, s);
  return (int)cudaErrorInvalidValue;
}
