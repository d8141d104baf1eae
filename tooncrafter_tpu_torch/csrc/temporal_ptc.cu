// Per-pixel temporal attention core (T-attention) for Hopper (sm_90a):
//
//   o[b, :, p, h] = bf16(bf16(softmax(q k^T * scale)) v)
//
// over the T frames of each pixel p, per head h of width D (64 or 128), with
// q, k, v the (T, D) slices of (B, T, P, heads * D) tensors. Replaces the TPU
// kernel tooncrafter_tpu/ops/temporal_attention.py::_ptc_kernel_call, which
// takes (B, P, T, inner); here q, k and v are read at their own (b, t, p)
// strides (the UNet's (B, T, P, C) layout, or slices of one packed q | k | v
// projection), so no transpose or copy precedes the kernel. The output is a
// contiguous (B, T, P, inner) tensor.
//
// Rounding, as the TPU kernel: the logits and the softmax in fp32 (max,
// exp, sum, divide), the probabilities rounded to bf16 before the product
// with v, whose fp32 sums round once to bf16.
//
// What bounds it on the H100: 4 T D operations per (pixel, head) and element
// of T, against 8 bytes moved for each element of q, k, v and o: ~8
// operations a byte at T = 16, far below the card's ~295, so the bytes do
// (0.063 ms at B = 2, T = 16, P = 2560, inner = 320). The design keeps the
// loads in flight and the arithmetic off the critical path:
//   * each operand is viewed as (C, T, P, B) at its own byte strides by a
//     4-D tensor map (temporal_attention.cu's view of z), in boxes of {64
//     channels, T_box frames, pixels, 1}: row r of a tile is frame r %
//     T_box of pixel r / T_box, 128 bytes in the 128-byte swizzle. T_box is
//     T where T divides 16 (16 / T whole pixels in 16 rows), else 16 (T <
//     16) or 32: the frames t >= T lie outside the map and arrive as
//     zeros, as do the pixels past P; the store clips both. d = 128 takes
//     two boxes a head;
//   * a work unit is (b, pixel tile, head), heads fastest (the heads of a
//     pixel tile share DRAM pages); one producer thread of a persistent
//     block (one an SM) keeps a ring of units' q, k and v in flight on
//     mbarriers (~190 KB at d = 64: Little's law asks ~25 KB an SM);
//   * two groups of consumer warps take the block's units in turns; a warp
//     owns 16 rows of the tile (32 where T_box = 32): q by ldmatrix as the
//     A fragments and k as the B fragments of q k^T (mma.sync m16n8k16,
//     fp32), x scale, -inf for a key of another pixel or a frame t >= T;
//     the fp32 softmax (max, expf, sum, divide); p rounded to bf16 is the A
//     fragment of p v, v's B fragments by ldmatrix.trans; o rounds once to
//     bf16 into the warp's swizzled staging tile and leaves by a TMA store
//     of the warp's whole pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {
namespace ptc {

constexpr int kMaxT = 32;
constexpr int kGroups = 2;  // consumer groups, taking the units in turns
constexpr int kBox = 64 * 2;  // bytes of a tile row: 64 channels

struct Params {
  int t;       // frames
  int tb;      // frames a box (T_box)
  int heads;
  int ppt;     // pixels a tile
  int ptiles;  // pixel tiles a sample: ceil(P / ppt)
  int units;   // B ptiles heads
  int warps;   // consumer warps a group
  int stages;  // ring stages
  float scale;
};

// The attention of one warp's RW rows (rows r0.. of the stage's tiles) of
// unit (b, px0, h); writes o into the warp's staging tile `stg` (NB boxes
// of RW rows) and stores it.
template <int D, int RW>
__device__ __forceinline__ void attend(const Params& p, const unsigned char* q,
                                       const unsigned char* k,
                                       const unsigned char* v, int tile,
                                       int r0, unsigned char* stg,
                                       uint64_t* empty,
                                       const CUtensorMap* tm_o, int b,
                                       int px0, int h) {
  constexpr int NB = D / 64;   // boxes a head
  constexpr int MT = RW / 16;  // m16 tiles of queries
  constexpr int NT = RW / 8;   // n8 tiles of keys
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: the A fragment (and v's .trans B fragments)
  // take rows (lane % 8) + 8 ((lane / 8) % 2), chunk + lane / 16; k's B
  // fragments rows (lane % 8) + 8 (lane / 16), chunk + (lane / 8) % 2
  const int ra = (lane & 7) + (((lane >> 3) & 1) << 3), ca = lane >> 4;
  const int rb = (lane & 7) + ((lane >> 4) << 3), cb = (lane >> 3) & 1;

  // logits = q k^T over the warp's RW keys (its own rows of k)
  float s[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[mi][nt][0] = s[mi][nt][1] = s[mi][nt][2] = s[mi][nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * tile, c0 = 2 * (kk % 4);
    uint32_t kf[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldmatrix_x4(kf[np], reinterpret_cast<const bf16*>(
                              k + off + sw128(r0 + 16 * np + rb, c0 + cb)));
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      uint32_t qa[4];
      ldmatrix_x4(qa, reinterpret_cast<const bf16*>(
                          q + off + sw128(r0 + 16 * mi + ra, c0 + ca)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        mma_16816(s[mi][2 * np], qa, kf[np][0], kf[np][1]);
        mma_16816(s[mi][2 * np + 1], qa, kf[np][2], kf[np][3]);
      }
    }
  }

  // the fp32 softmax of each query row over the keys of its pixel; thread
  // (g, t4) holds s[mi][nt][2 hr + e] of row 16 mi + g + 8 hr, key 8 nt +
  // 2 t4 + e (warp-local)
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = 16 * mi + g + 8 * hr;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * nt + 2 * t4 + e;
          const bool same_pixel = key / p.tb == qi / p.tb;
          const bool real_frame = key % p.tb < p.t;
          float& x = s[mi][nt][2 * hr + e];
          x = same_pixel && real_frame ? x * p.scale : -INFINITY;
          m = fmaxf(m, x);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float den = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mi][nt][2 * hr + e];
          x = expf(x - m);
          den += x;
        }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) s[mi][nt][2 * hr + e] /= den;
    }
  // p rounded to bf16: the A fragments of p v, one per 16 keys
  uint32_t pa[MT][NT / 2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      pa[mi][kp][0] = pack_bf16(s[mi][2 * kp][0], s[mi][2 * kp][1]);
      pa[mi][kp][1] = pack_bf16(s[mi][2 * kp][2], s[mi][2 * kp][3]);
      pa[mi][kp][2] = pack_bf16(s[mi][2 * kp + 1][0], s[mi][2 * kp + 1][1]);
      pa[mi][kp][3] = pack_bf16(s[mi][2 * kp + 1][2], s[mi][2 * kp + 1][3]);
    }

  // o = p v, 16 columns of d at a time, each rounded into the staging tile
  // (the previous unit's store has read it)
  if (lane == 0) sm90::bulk_wait_read<0>();
  __syncwarp();
#pragma unroll
  for (int jp = 0; jp < D / 16; ++jp) {
    const int off = (jp / 4) * tile, c0 = 2 * (jp % 4);
    float o[MT][2][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < 2; ++n) o[mi][n][0] = o[mi][n][1] = o[mi][n][2] =
          o[mi][n][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, v + off + sw128(r0 + 16 * kp + ra, c0 + ca));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_16816(o[mi][0], pa[mi][kp], vf[0], vf[1]);
        mma_16816(o[mi][1], pa[mi][kp], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t px = sm90::smem_u32(stg) + (jp / 4) * RW * kBox +
                            sw128(16 * mi + g, c0 + n) + 4 * t4;
        sts32(px, pack_bf16(o[mi][n][0], o[mi][n][1]));
        sts32(px + 8 * kBox, pack_bf16(o[mi][n][2], o[mi][n][3]));
      }
  }
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(empty);  // q, k and v of the unit read
  sm90::fence_async_smem();
  __syncwarp();
  if (lane == 0) {
    for (int hb = 0; hb < NB; ++hb)
      sm90::tma_store_4d(tm_o, stg + hb * RW * kBox, h * D + 64 * hb, 0,
                         px0 + r0 / p.tb, b);
    sm90::bulk_commit();
  }
}

// Shared memory: `stages` stages of [q | k | v], each NB boxes of R = warps
// RW rows (1024-byte multiples), the consumer warps' staging tiles (NB boxes
// of RW rows each), then the full and empty barriers.
template <int D, int RW>
__global__ void __launch_bounds__((kGroups * 4 + 1) * 32, 1)
ptc_kernel(const Params p, const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_o) {
  constexpr int NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tile = p.warps * RW * kBox;  // one box of the stage
  const int stage = 3 * NB * tile;
  const int cw = kGroups * p.warps;      // consumer warps
  unsigned char* staging = base + p.stages * stage;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + cw * NB * RW * kBox);
  uint64_t* empty = full + p.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mine =
      (p.units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], p.warps);  // the group's warps read it
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == cw) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < mine; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages)
          sm90::mbar_wait(&empty[s], ((i / p.stages) & 1) ^ 1);
        const int u = blockIdx.x + i * gridDim.x;
        const int h = u % p.heads, r = u / p.heads;
        const int px0 = (r % p.ptiles) * p.ppt, b = r / p.ptiles;
        unsigned char* st = base + s * stage;
        sm90::mbar_expect_tx(&full[s], stage);
        for (int hb = 0; hb < NB; ++hb) {
          const int c0 = h * D + 64 * hb;
          sm90::tma_load_4d(st + hb * tile, &tm_q, &full[s], c0, 0, px0, b);
          sm90::tma_load_4d(st + (NB + hb) * tile, &tm_k, &full[s], c0, 0,
                            px0, b);
          sm90::tma_load_4d(st + (2 * NB + hb) * tile, &tm_v, &full[s], c0,
                            0, px0, b);
        }
      }
    }
    return;
  }

  const int grp = warp / p.warps, r0 = (warp % p.warps) * RW;
  unsigned char* stg = staging + warp * NB * RW * kBox;
  for (int i = grp; i < mine; i += kGroups) {
    const int s = i % p.stages;
    sm90::mbar_wait(&full[s], (i / p.stages) & 1);
    const int u = blockIdx.x + i * gridDim.x;
    const int h = u % p.heads, r = u / p.heads;
    const unsigned char* st = base + s * stage;
    attend<D, RW>(p, st, st + NB * tile, st + 2 * NB * tile, tile, r0, stg,
                  &empty[s], &tm_o, r / p.ptiles, (r % p.ptiles) * p.ppt, h);
  }
  if (lane == 0) sm90::bulk_wait<0>();  // the last store is out
}

// an operand (B, T, P, inner) at element strides s (b, t, p) viewed as
// (inner, T, P, B), in boxes of {64, tb, pixels, 1}
int make_map(CUtensorMap* map, const void* base, const long long* s, int b,
             int t, int p, int inner, int tb, int pixels) {
  const uint64_t dims[4] = {(uint64_t)inner, (uint64_t)t, (uint64_t)p,
                            (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)s[1] * 2, (uint64_t)s[2] * 2,
                               (uint64_t)s[0] * 2};
  const uint32_t box[4] = {64u, (uint32_t)tb, (uint32_t)pixels, 1u};
  return sm90_host::make_map(map, base, 4, dims, strides, box);
}

int smem_bytes(int d, int rw, int warps, int stages) {
  const int nb = d / 64, tile = warps * rw * kBox;
  return stages * 3 * nb * tile + kGroups * warps * nb * rw * kBox +
         2 * stages * 8 + 1024;
}

template <int D, int RW>
int launch(const Params& p, const CUtensorMap (&m)[4], int grid, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ptc_kernel<D, RW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ptc_kernel<D, RW><<<grid, (kGroups * p.warps + 1) * 32, smem, stream>>>(
      p, m[0], m[1], m[2], m[3]);
  return (int)cudaGetLastError();
}

}  // namespace ptc
}  // namespace

// q, k, v: bf16 (b, t, p, heads * d) at element strides s*[0..2] of b, t and
// p (the last axis contiguous, every stride a multiple of 8, the pointers
// 16-byte aligned); out: contiguous bf16 (b, t, p, heads * d). t <= 32, d 64
// or 128. The plan (ops/temporal_attention.ptc_plan): tb frames a box (t
// where t divides 16, else 16 or 32), `warps` consumer warps a group (4, or
// 2 at d = 128 with tb = 32), `stages` ring stages and `grid` persistent
// blocks. Returns a cudaError_t code (0 on success).
extern "C" int tc_temporal_ptc(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int b,
                               int t, int p, int heads, int d, float scale,
                               int tb, int warps, int stages, int grid,
                               void* stream) {
  using namespace ptc;
  const int want_tb = 16 % t == 0 ? t : (t <= 16 ? 16 : 32);
  if (b <= 0 || t <= 0 || t > kMaxT || p <= 0 || heads <= 0 ||
      (d != 64 && d != 128) || tb != want_tb || (warps != 4 && warps != 2) ||
      stages < 2 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int rw = tb == 32 ? 32 : 16;
  Params prm;
  prm.t = t;
  prm.tb = tb;
  prm.heads = heads;
  prm.ppt = warps * rw / tb;
  prm.ptiles = (p + prm.ppt - 1) / prm.ppt;
  const long long units = (long long)b * prm.ptiles * heads;
  if (units >= (1ll << 31) || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  prm.units = (int)units;
  prm.warps = warps;
  prm.stages = stages;
  prm.scale = scale;
  const int inner = heads * d;
  CUtensorMap m[4];
  const long long so[3] = {(long long)t * p * inner, (long long)p * inner,
                           inner};
  int err = make_map(&m[0], q, strides, b, t, p, inner, tb, prm.ppt);
  if (!err) err = make_map(&m[1], k, strides + 3, b, t, p, inner, tb, prm.ppt);
  if (!err) err = make_map(&m[2], v, strides + 6, b, t, p, inner, tb, prm.ppt);
  if (!err) err = make_map(&m[3], out, so, b, t, p, inner, tb, rw / tb);
  if (err) return err;
  const int smem = smem_bytes(d, rw, warps, stages);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return rw == 16 ? launch<64, 16>(prm, m, grid, smem, s)
                    : launch<64, 32>(prm, m, grid, smem, s);
  return rw == 16 ? launch<128, 16>(prm, m, grid, smem, s)
                  : launch<128, 32>(prm, m, grid, smem, s);
}
