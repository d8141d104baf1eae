// Temporal (3,1,1) convolution for Hopper (sm_90a) with the fused GroupNorm
// prologue and the scale / residual / statistics epilogue, bf16 in and out:
//
//   z[s]  = silu(x[s] * A + B)              (fp32, rounded once to bf16)
//   y[t]  = (z[t-1] W0 + z[t] W1 + z[t+1] W2 + b) * scale + residual[t]
//   stats = per-frame, per-channel fp32 sums of y and y^2 (of the rounded y)
//
// z is zero at t = -1 and t = T: the padding is of z, not of x (the
// prologue runs before the window, as _xla_tconv pads after it).
//
// Replaces the TPU kernel tooncrafter_tpu/ops/temporal_conv.py::
// _pallas_tconv. Its callers: the UNet's TemporalConvBlock (four convs
// chained through their stats, the last with the block residual) and the
// dual-ref decoder's TimeStack (the alpha merge x + sigmoid(mix) * stack(x)
// as scale + residual).
//
// Design: two kernels on one stream, split at z, the tensor the TPU kernel
// itself rounds to bf16, so passing it through device memory in bf16
// changes no number:
//   (a) zpass_kernel: a bandwidth pass that reads x once and writes z once
//       into a zero-framed buffer zf (B, T + 2, P, Cin): frames 0 and T + 1
//       of each sample are zeros (the zero of z), frame t + 1 is z of x's
//       frame t. Each thread keeps eight channels' affine in registers and
//       walks pixel rows, 16 bytes in and out a row; without a prologue it
//       only frames x.
//   (b) gemm_kernel: the persistent wgmma GEMM of persistent_gemm.cuh with
//       a shifted A operand. M = the T P rows of one sample in BM-row tiles
//       that run across frame boundaries (a ragged P wastes no rows), N =
//       Cout, K = 3 taps x Cin. Tap k's A tile is the box of zf at row m0 +
//       k P of the sample: one tensor map, no masks, because the zero
//       frames pad. B is the weight in its (Cout, 3, Cin) layout, K-major,
//       read by a 3-D map (Cin, 3, Cout) that zero-fills each tap's ragged
//       last K block. Column tiles run fastest, so consecutive tiles read
//       one A row tile from L2, and the weight is read once per M tile;
//       where frames are whole tiles, row tiles walk the T frames of one
//       pixel block first, so each z row's three taps are read from L2.
//       Epilogue: bias, then the scale, then the residual (brought by TMA
//       while the products run), one rounding, the tile staged in shared
//       memory and stored by TMA (3-D maps clip each sample's ragged last
//       tile); then the per-frame sums from the staged, rounded tile.
// Stats without atomics: frame f of a sample is touched by the row tiles
// first(f) = f P / BM .. last(f); tile i writes its sums of frame f into
// slot i - first(f) of an fp32 (B, T, slots, Cout) buffer, and tile
// last(f) zeroes the slots past its own, so the caller's sum over the
// slots (a fixed order) gives deterministic per-frame sums.
//
// What bounds it on the H100: at the UNet's C >= 320 the products (2 * 3 C
// operations per output element, ~ 3 C / 4 operations a byte of x, z and
// y); at the decoder's level 0 (C = 128) the bytes: x read, z written and
// read (at least once; three taps hit L2), y (and the residual) moved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "persistent_gemm.cuh"
#include "sm90.cuh"

namespace {
namespace tconv {

// ---------------------------------------------------------------------------
// (a) the z pass
// ---------------------------------------------------------------------------

constexpr int kZRows = 4;  // pixel rows a thread: loads in flight

// the SiLU with the fast exponential and reciprocal (a few fp32 ulps, far
// below the bf16 rounding that follows)
__device__ __forceinline__ float silu(float v) {
  return v * __frcp_rn(1.f + __expf(-v));
}

// z for eight channels: the affine and the SiLU in fp32, one rounding
__device__ __forceinline__ uint4 prologue8(uint4 v, const float (&av)[8],
                                          const float (&bv)[8],
                                          int silu_on) {
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
    float z0 = x.x * av[2 * j] + bv[2 * j];
    float z1 = x.y * av[2 * j + 1] + bv[2 * j + 1];
    if (silu_on) {
      z0 = silu(z0);
      z1 = silu(z1);
    }
    u[j] = pack_bf16(z0, z1);
  }
  return v;
}

// Block: cin / 8 channel groups x `rows` pixel rows (blockDim.x = cin / 8
// rows); grid: (pixel tiles of rows kZRows, B (T + 2) frames of zf).
__global__ void __launch_bounds__(1024)
zpass_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ b, bf16* __restrict__ zf, int t, int p,
             int cin, int silu_on) {
  const int groups = cin >> 3;
  const int cg = threadIdx.x % groups;
  const int ty = threadIdx.x / groups;
  const int rows = blockDim.x / groups;
  const int frame = blockIdx.y;  // of zf
  const int smp = frame / (t + 2), tf = frame - smp * (t + 2);
  const bool pad = tf == 0 || tf == t + 1;
  float av[8], bv[8];
  if (a != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 ah = *reinterpret_cast<const float4*>(
          a + (long long)smp * cin + cg * 8 + 4 * h);
      const float4 bh = *reinterpret_cast<const float4*>(
          b + (long long)smp * cin + cg * 8 + 4 * h);
      av[4 * h] = ah.x, av[4 * h + 1] = ah.y, av[4 * h + 2] = ah.z;
      av[4 * h + 3] = ah.w;
      bv[4 * h] = bh.x, bv[4 * h + 1] = bh.y, bv[4 * h + 2] = bh.z;
      bv[4 * h + 3] = bh.w;
    }
  }
  const long long src = (long long)smp * t + tf - 1;  // x's frame
  const int p0 = blockIdx.x * rows * kZRows + ty;
  uint4 v[kZRows];
#pragma unroll
  for (int j = 0; j < kZRows; ++j) {
    const int px = p0 + j * rows;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (!pad && px < p)
      v[j] = *reinterpret_cast<const uint4*>(x + (src * p + px) * cin +
                                             cg * 8);
  }
#pragma unroll
  for (int j = 0; j < kZRows; ++j) {
    const int px = p0 + j * rows;
    if (px >= p) continue;
    if (a != nullptr) v[j] = prologue8(v[j], av, bv, silu_on);
    if (pad) v[j] = make_uint4(0u, 0u, 0u, 0u);  // z, not x, is zero there
    *reinterpret_cast<uint4*>(zf + ((long long)frame * p + px) * cin +
                              cg * 8) = v[j];
  }
}

// ---------------------------------------------------------------------------
// (b) the three-tap GEMM
// ---------------------------------------------------------------------------

using pgemm::kBK;

struct Params {
  const bf16* bias;    // (cout)
  const bf16* res;     // (B, T, P, cout), or null
  const float* scale;  // a device scalar, or null
  float* s1;           // (B, T, slots, cout), or null: no sums
  float* s2;
  int t, p, tp;        // frames, pixels a frame, T P rows a sample
  int cout;
  int kc;              // K blocks a tap: ceil(cin / 64)
  int mtiles, ntiles, tiles, slots;
  int walk;            // P % BM == 0: the row tiles walk the frames first
};

// BM rows x BN output columns a warpgroup tile; the staging area holds the
// tile, which first takes in the residual, BN / 32 boxes of 32 columns in
// the 64-byte swizzle. tm_z: zf (cin, (T + 2) P, B); tm_w: the weight (cin,
// 3, cout); tm_y, tm_r: the output and the residual (cout, T P, B).
template <int BM, int BN>
struct TapOp {
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int kStaging = BM * BN * 2;
  static constexpr int kExtra = 0;
  Params p;
  const CUtensorMap* tm_z;
  const CUtensorMap* tm_w;
  const CUtensorMap* tm_y;
  const CUtensorMap* tm_r;

  // the tile's sample, row tile and first output channel
  struct Tile {
    int smp, mt, n0;
  };

  // tile t: (sample, row tile, column tile), column tiles fastest. Where
  // every frame is whole tiles, the row tiles of one pixel block in the T
  // frames come one after another, so the three taps' reads of each z row
  // fall on concurrent tiles and hit L2 (at the decoder's level 0 a frame
  // of z is tens of MB: in row order its taps would come from device
  // memory three times).
  __device__ __forceinline__ Tile tile(int t) const {
    const int r = t / p.ntiles;
    const int i = r % p.mtiles;
    return {r / p.mtiles,
            p.walk ? (i % p.t) * (p.mtiles / p.t) + i / p.t : i,
            (t % p.ntiles) * BN};
  }
  __device__ __forceinline__ int tiles() const { return p.tiles; }
  __device__ __forceinline__ int kblocks() const { return 3 * p.kc; }

  // K block kb = tap k, channels k0..: z's rows of frame t - 1 + k, which
  // sit k P rows further down zf than frame t - 1 does
  __device__ __forceinline__ void load(void* a, void* b, uint64_t* bar,
                                       const Tile& c, int kb) const {
    const int tap = kb / p.kc;
    const int k0 = (kb - tap * p.kc) * kBK;
    sm90::tma_load_3d(a, tm_z, bar, k0, c.mt * BM + tap * p.p, c.smp);
    sm90::tma_load_3d(b, tm_w, bar, k0, tap, c.n0);
  }

  // the residual tile, once the last store read the staging area
  __device__ __forceinline__ void before(const Tile& c, unsigned char* stage,
                                         unsigned char*,
                                         uint64_t* xbar) const {
    if (p.res == nullptr) return;
    sm90::bulk_wait_read<0>();
    sm90::mbar_expect_tx(xbar, kStaging);
    for (int j = 0; j < BN / 32; ++j)
      sm90::tma_load_3d(stage + j * BM * 64, tm_r, xbar, c.n0 + 32 * j,
                        c.mt * BM, c.smp);
  }

  // y = (acc + bias) * scale + residual, one rounding, into the staging
  // tile (box j / 4 of 32 columns, its 16-byte chunk c of row r at c ^ ((r
  // / 2) % 4): conflict-free); one thread stores it by TMA; then the sums
  __device__ __forceinline__ void epilogue(float (&acc)[BM / 64][BN / 2],
                                           const Tile& c, int parity,
                                           int wgi, unsigned char* stage,
                                           unsigned char*,
                                           uint64_t* xbar) const {
    constexpr int kMT = BM / 64;
    const int n0 = c.n0;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2, t4 = lane & 3;
    const bool res = p.res != nullptr;
    if (res)
      sm90::mbar_wait(xbar, parity);
    else
      pgemm::epi_wait_staging(wgi);
    const float scale = p.scale != nullptr ? *p.scale : 1.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      const float2 c2 =
          col < p.cout ? ld_bf162(p.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * mi + 16 * warp + g + 8 * r;
          uint32_t* px = reinterpret_cast<uint32_t*>(
              stage + (j / 4) * BM * 64 + row * 64 +
              (((j & 3) ^ ((row >> 1) & 3)) << 4) + 4 * t4);
          float y0 = (acc[mi][4 * j + 2 * r] + c2.x) * scale;
          float y1 = (acc[mi][4 * j + 2 * r + 1] + c2.y) * scale;
          if (res) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(px));
            y0 += rv.x;
            y1 += rv.y;
          }
          *px = pack_bf16(y0, y1);
        }
    }
    pgemm::epi_publish(wgi);
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < BN / 32; ++j)
        sm90::tma_store_3d(tm_y, stage + j * BM * 64, n0 + 32 * j,
                           c.mt * BM, c.smp);
      sm90::bulk_commit();
    }
    if (p.s1 != nullptr) frame_sums(stage, c.smp, c.mt, n0);
  }

  // Per-frame sums of the staged (rounded) tile: a thread a column pair
  // walks the tile's rows frame by frame; rows past T P are not summed.
  __device__ __forceinline__ void frame_sums(const unsigned char* stage,
                                             int smp, int mt, int n0) const {
    const int m0 = mt * BM;
    const int rows = min(BM, p.tp - m0);
    for (int cp = threadIdx.x & 127; cp < BN / 2; cp += 128) {
      const int col = n0 + 2 * cp;
      if (col >= p.cout) break;
      const unsigned char* colp = stage + (cp >> 4) * BM * 64 + 4 * (cp & 3);
      const int chunk = (cp >> 2) & 3;
      int f = m0 / p.p;  // the frame of the tile's first row
      for (int r = 0; r < rows; ++f) {
        const int fend = (f + 1) * p.p - m0;  // past frame f's last row
        const int end = min(rows, fend);
        float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f;
        for (; r < end; ++r) {
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  colp + r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4)));
          a0 += y.x;
          a1 += y.y;
          q0 += y.x * y.x;
          q1 += y.y * y.y;
        }
        // this tile's slot among the row tiles that frame f touches
        const int slot = mt - (f * p.p) / BM;
        const long long o =
            (((long long)smp * p.t + f) * p.slots + slot) * p.cout + col;
        *reinterpret_cast<float2*>(p.s1 + o) = make_float2(a0, a1);
        *reinterpret_cast<float2*>(p.s2 + o) = make_float2(q0, q1);
        if (fend <= rows)  // frame f's last tile: zero the slots past it
          for (int s = 1; slot + s < p.slots; ++s) {
            const long long z = o + (long long)s * p.cout;
            *reinterpret_cast<float2*>(p.s1 + z) = make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(p.s2 + z) = make_float2(0.f, 0.f);
          }
      }
    }
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(pgemm::kThreads, 1)
gemm_kernel(const Params p, const __grid_constant__ CUtensorMap tm_z,
            const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_y,
            const __grid_constant__ CUtensorMap tm_r) {
  extern __shared__ unsigned char smem_raw[];
  const TapOp<BM, BN> op{p, &tm_z, &tm_w, &tm_y, &tm_r};
  pgemm::run(op, smem_raw);
}

// a bf16 tensor (inner, mid, outer), innermost first and contiguous, in
// boxes of {box0, box1, box2}
int make_map3(CUtensorMap* map, const void* base, int inner, int mid,
              int outer, int box0, int box1, int box2,
              CUtensorMapSwizzle swizzle) {
  const uint64_t dims[3] = {(uint64_t)inner, (uint64_t)mid, (uint64_t)outer};
  const uint64_t strides[2] = {(uint64_t)inner * 2,
                               (uint64_t)inner * mid * 2};
  const uint32_t box[3] = {(uint32_t)box0, (uint32_t)box1, (uint32_t)box2};
  return sm90_host::make_map(map, base, 3, dims, strides, box, swizzle);
}

template <int BM, int BN>
int launch_gemm(Params p, const void* zf, const void* w, void* out, int batch,
                int cin, int grid, cudaStream_t stream) {
  using R = pgemm::RingOf<TapOp<BM, BN>>;
  p.mtiles = (p.tp + BM - 1) / BM;
  p.ntiles = (p.cout + BN - 1) / BN;
  p.tiles = batch * p.mtiles * p.ntiles;
  p.walk = p.p % BM == 0;
  if (grid < 1 || grid > p.tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap tz, tw, ty, tr;  // zf, the weight, the output, the residual
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto sw64 = CU_TENSOR_MAP_SWIZZLE_64B;
  int err = make_map3(&tz, zf, cin, (p.t + 2) * p.p, batch, kBK, BM, 1, sw128);
  if (!err) err = make_map3(&tw, w, cin, 3, p.cout, kBK, 1, BN, sw128);
  if (!err) err = make_map3(&ty, out, p.cout, p.tp, batch, 32, BM, 1, sw64);
  if (err) return err;
  if (p.res != nullptr)
    err = make_map3(&tr, p.res, p.cout, p.tp, batch, 32, BM, 1, sw64);
  else
    tr = ty;
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kBytes);
  if (e != cudaSuccess) return (int)e;
  gemm_kernel<BM, BN><<<grid, pgemm::kThreads, R::kBytes, stream>>>(
      p, tz, tw, ty, tr);
  return (int)cudaGetLastError();
}

}  // namespace tconv
}  // namespace

// x (B, T, P, cin), w (cout, 3, cin): taps t-1, t, t+1, bias (cout),
// res/out (B, T, P, cout): contiguous bf16; a, b: fp32 (B, cin) or both
// null (no prologue, silu 0); scale: a device fp32 scalar or null. Scratch
// from the caller: zf (B, T + 2, P, cin) bf16. s1, s2: fp32 (B, T, slots,
// cout), or both null. The GEMM's tiles: bm (64 or 128) rows x bn (128 or
// 160) columns on `grid` persistent blocks (at most its tiles). cin % 8 ==
// 0 (at most 8192), cout % 8 == 0. Returns a cudaError_t code (0 on
// success).
extern "C" int tc_temporal_conv(const void* x, const void* w, const void* bias,
                                const float* a, const float* b, const void* res,
                                const float* scale, void* zf, void* out,
                                float* s1, float* s2, int batch, int t, int p,
                                int cin, int cout, int silu, int bm, int bn,
                                int grid, int slots, void* stream) {
  using namespace tconv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || t <= 0 || p <= 0 || cin <= 0 || cin % 8 || cin > 8192 ||
      cout <= 0 || cout % 8 || batch * (t + 2) > 65535 ||
      (long long)t * p > (1ll << 30) || (a == nullptr) != (b == nullptr) ||
      (silu && a == nullptr) || (s1 == nullptr) != (s2 == nullptr) ||
      (s1 != nullptr && slots < 1))
    return (int)cudaErrorInvalidValue;
  const int groups = cin / 8;
  const int rows = groups >= 256 ? 1 : 256 / groups;
  const dim3 zgrid((p + rows * kZRows - 1) / (rows * kZRows), batch * (t + 2));
  zpass_kernel<<<zgrid, groups * rows, 0, s>>>(
      static_cast<const bf16*>(x), a, b, static_cast<bf16*>(zf), t, p, cin,
      silu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Params q{};
  q.bias = static_cast<const bf16*>(bias);
  q.res = static_cast<const bf16*>(res);
  q.scale = scale;
  q.s1 = s1;
  q.s2 = s2;
  q.t = t;
  q.p = p;
  q.tp = t * p;
  q.cout = cout;
  q.kc = (cin + kBK - 1) / kBK;
  q.slots = slots;
  if (bm == 128 && bn == 160)
    return launch_gemm<128, 160>(q, zf, w, out, batch, cin, grid, s);
  if (bm == 128 && bn == 128)
    return launch_gemm<128, 128>(q, zf, w, out, batch, cin, grid, s);
  if (bm == 64 && bn == 160)
    return launch_gemm<64, 160>(q, zf, w, out, batch, cin, grid, s);
  if (bm == 64 && bn == 128)
    return launch_gemm<64, 128>(q, zf, w, out, batch, cin, grid, s);
  return (int)cudaErrorInvalidValue;
}
