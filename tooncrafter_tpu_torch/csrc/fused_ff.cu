// GEGLU feed-forward for Hopper (sm_90a), bf16 in and out, as three
// kernels on one stream:
//
//   (a) z = LN(x)                                ln_kernel      (N x C)
//   (b) m = (z W1h^T + b1h) gelu(z W1g^T + b1g)  gemm_kernel<kGate> (N x D)
//   (c) y = m W2^T + b2 [+ x]                    gemm_kernel<kOut>  (N x Cout)
//
// Replaces the two TPU kernels of tooncrafter_tpu/ops/fused_ff.py:
//   * _pallas_ff           weights resident in VMEM (C <= 640)
//   * _pallas_ff_streamed  weight chunks streamed from HBM (C = 1280)
// The TPU split them only because of VMEM; they compute one function, and
// these kernels serve both (one call counts one launch of the TPU
// kernel's name).
//
// Why the split at z and m changes no number: the TPU kernel rounds the
// LayerNorm output to bf16 before the projection (_ln_tile) and the gated
// product m to bf16 before the out-GEMM (fused_ff.py:242, :310). Those
// are the two tensors that pass through device memory here, in bf16, so
// the products consume the values the TPU kernel's products consume. The
// cost is bytes: z and m are written once and read once. Without LN (a)
// is skipped and (b) reads x.
//
// What bounds each part on the H100:
//   * (a) bytes: a row read and written, a few FP32 operations an element;
//   * (b) operations: 4 N C D on the tensor cores against 2 (N C + N D)
//     bytes (~380 operations a byte at C = 320, above the card's ~295),
//     plus one exact erff an element of m on the FP32 units, about half
//     the products' time at C = 320, so it has to run beside them;
//   * (c) at C = 320 the bytes of m: 2 N D C operations on 2 N D bytes is
//     C operations a byte, about the card's ratio; at C >= 640 the
//     operations.
//
// Design of (b) and (c): the persistent mainloop of persistent_gemm.cuh
// (a TMA ring fed by a producer thread, two consumer warpgroups in
// ping-pong on the tensor cores, column tiles fastest) with two epilogues
// (template parameter EPI):
//   * A is z, x or m, B is W1 or W2 in torch's Linear layout, K-major;
//   * (b): a tile's B is 64 rows of W1's h half and the 64 rows of its
//     gate half at the same index (rows D + j), one 128-row wgmma operand,
//     so h and g of one (token, d) land in one thread's accumulator: the
//     gate (fp32 biases, brought per tile by a bulk copy, exact erff) runs
//     on registers and only m rounds;
//   * (c): y = bf16(bf16(acc) + b2), then + x rounded (fused_ff.py:246-247,
//     :317), the residual tile brought by TMA while the products run;
//   * each epilogue writes its tile into shared memory (swizzled, no bank
//     conflicts) and one thread stores it by TMA, which leaves rows past N
//     and columns past Cout out; rows past N arrive as zeros.
// Tiles (chosen by the wrapper, ops/fused_ff.py `plan`): 128 rows unless
// that gives fewer tiles than SMs, then 64; (b) 64 + 64 columns, (c) 160
// where Cout allows, else 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent_gemm.cuh"
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float2 ld_bf162(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// eight bf16 (16 bytes) as floats
__device__ __forceinline__ void ld_bf16x8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

namespace fused_ff {

// ---------------------------------------------------------------------------
// (a) the LayerNorm: one warp a row, 16-byte loads and stores
// ---------------------------------------------------------------------------

constexpr int kLnRows = 8;  // rows (warps) a block

// z for the 8 columns of x from k: the fp32 affine, one rounding to bf16
__device__ __forceinline__ uint4 ln8(const float (&xv)[8], float mean,
                                    float rstd, const float* lnw,
                                    const float* lnb, int k) {
  const float4 w0 = *reinterpret_cast<const float4*>(lnw + k);
  const float4 w1 = *reinterpret_cast<const float4*>(lnw + k + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(lnb + k);
  const float4 b1 = *reinterpret_cast<const float4*>(lnb + k + 4);
  const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  float zf[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) zf[e] = (xv[e] - mean) * rstd * wv[e] + bv[e];
  return make_uint4(pack_bf16(zf[0], zf[1]), pack_bf16(zf[2], zf[3]),
                    pack_bf16(zf[4], zf[5]), pack_bf16(zf[6], zf[7]));
}

// fp32 statistics, variance E[x^2] - mean^2 clamped at 0 (the TPU's
// _ln_tile). A lane takes the row's 16-byte chunks lane, lane + 32, ...;
// NCH > 0: at most NCH of them, kept in registers between the statistics
// and the affine (C <= 256 NCH); NCH = 0: any C, the row read twice.
template <int NCH>
__global__ void __launch_bounds__(kLnRows * 32)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
          const float* __restrict__ lnb, bf16* __restrict__ z, int n, int c,
          float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= n) return;
  const bf16* xr = x + row * c;
  bf16* zr = z + row * c;
  float v[NCH > 0 ? NCH : 1][8];
  float s = 0.f, s2 = 0.f;
  auto add = [&](const float (&u)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += u[e];
      s2 += u[e] * u[e];
    }
  };
  if constexpr (NCH > 0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k < c) {
        ld_bf16x8(xr + k, v[i]);
        add(v[i]);
      }
    }
  } else {
    for (int k = lane * 8; k < c; k += 256) {
      ld_bf16x8(xr + k, v[0]);
      add(v[0]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / c;
  const float var = fmaxf(s2 / c - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if constexpr (NCH > 0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k < c)
        *reinterpret_cast<uint4*>(zr + k) =
            ln8(v[i], mean, rstd, lnw, lnb, k);
    }
  } else {
    for (int k = lane * 8; k < c; k += 256) {
      ld_bf16x8(xr + k, v[0]);
      *reinterpret_cast<uint4*>(zr + k) = ln8(v[0], mean, rstd, lnw, lnb, k);
    }
  }
}

template <int NCH>
int launch_ln(const void* x, const float* lnw, const float* lnb, void* z,
              int n, int c, float eps, cudaStream_t stream) {
  ln_kernel<NCH><<<(n + kLnRows - 1) / kLnRows, kLnRows * 32, 0, stream>>>(
      static_cast<const bf16*>(x), lnw, lnb, static_cast<bf16*>(z), n, c,
      eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// (b), (c): the wgmma GEMM, D (N x cols) = A (N x K) B (rows x K)^T
// ---------------------------------------------------------------------------

constexpr int kGate = 0;  // (b): m = (h + b1h) gelu(g + b1g), rounded
constexpr int kOut = 1;   // (c): y = bf16(bf16(acc) + b2) [+ x]
using pgemm::kBK;

struct GemmParams {
  const bf16* bias;  // b1 (2d) or b2 (cols)
  const bf16* res;   // (kOut) x (n, cols), or null: no residual
  bf16* out;         // m (n, cols = d) or y (n, cols = cout)
  int n;             // token rows
  int cols;          // output columns
  int d;             // (kGate) the gate rows' offset in W1
  int kblocks;       // ceil(K / 64)
  int ntiles;        // column tiles
  int tiles;         // row tiles x column tiles
};

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The two GEMMs as ops of the shared mainloop (persistent_gemm.cuh): BM
// rows x BN accumulator columns a warpgroup tile. kGate: BN = 128, the
// output tile is 64 columns of m (accumulator columns 0-63 h, 64-127 g);
// kOut: the output tile is BN columns of y. The staging area holds the
// output tile (kGate: BM x 64 of m, one 128-byte-swizzled box; kOut: BM x
// BN of y, which first takes in the residual, BN / 32 boxes of 32 columns
// in the 64-byte swizzle); kGate's extra area its 64 + 64 biases. tm_c:
// the output as the stores see it; tm_x (kOut with a residual): x as its
// loads see it.
template <int EPI, int BM, int BN>
struct GemmOp {
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int kCols = EPI == kGate ? BN / 2 : BN;  // output cols
  static constexpr int kStaging = BM * kCols * 2;
  static constexpr int kExtra = EPI == kGate ? 2 * kBK * 2 : 0;
  static_assert(EPI == kOut || BN == 128, "the gate tile is 64 + 64");
  GemmParams p;
  const CUtensorMap* tm_a;
  const CUtensorMap* tm_b;
  const CUtensorMap* tm_c;
  const CUtensorMap* tm_x;

  // the tile's first row and first output column (kGate: of m; the h rows
  // of W1 there, the gate rows D further)
  struct Tile {
    int m0, n0;
  };

  __device__ __forceinline__ Tile tile(int t) const {
    return {(t / p.ntiles) * BM, (t % p.ntiles) * kCols};
  }
  __device__ __forceinline__ int tiles() const { return p.tiles; }
  __device__ __forceinline__ int kblocks() const { return p.kblocks; }

  // A's rows m0..; B's BN rows as two halves: kGate the h rows n0.. and the
  // gate rows D + n0.., kOut consecutive rows
  __device__ __forceinline__ void load(void* a, void* b, uint64_t* bar,
                                       const Tile& c, int kb) const {
    const int r1 = EPI == kGate ? p.d + c.n0 : c.n0 + BN / 2;
    unsigned char* sb = static_cast<unsigned char*>(b);
    sm90::tma_load_2d(a, tm_a, bar, kb * kBK, c.m0);
    sm90::tma_load_2d(sb, tm_b, bar, kb * kBK, c.n0);
    sm90::tma_load_2d(sb + BN * kBK, tm_b, bar, kb * kBK, r1);
  }

  // kGate: the tile's h and g biases; kOut with a residual: the residual
  // tile, once the last store read the staging area
  __device__ __forceinline__ void before(const Tile& c, unsigned char* stage,
                                         unsigned char* extra,
                                         uint64_t* xbar) const {
    const int m0 = c.m0, n0 = c.n0;
    if constexpr (EPI == kGate) {
      bf16* bias_s = reinterpret_cast<bf16*>(extra);
      sm90::mbar_expect_tx(xbar, kExtra);
      sm90::bulk_load(bias_s, p.bias + n0, 2 * kBK, xbar);
      sm90::bulk_load(bias_s + kBK, p.bias + p.d + n0, 2 * kBK, xbar);
    } else if (p.res != nullptr) {
      sm90::bulk_wait_read<0>();
      sm90::mbar_expect_tx(xbar, kStaging);
      for (int b = 0; b < BN / 32; ++b)
        sm90::tma_load_2d(stage + b * BM * 64, tm_x, xbar, n0 + 32 * b, m0);
    }
  }

  // The epilogue writes the tile's outputs into the staging area, and one
  // thread stores it by TMA, which leaves rows and columns past the
  // tensor's end out.
  __device__ __forceinline__ void epilogue(float (&acc)[BM / 64][BN / 2],
                                           const Tile& c, int parity,
                                           int wgi, unsigned char* stage,
                                           unsigned char* extra,
                                           uint64_t* xbar) const {
    constexpr int kMT = BM / 64;
    const int m0 = c.m0, n0 = c.n0;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2, t4 = lane & 3;
    const bool res = EPI == kOut && p.res != nullptr;
    if (EPI == kGate || res) sm90::mbar_wait(xbar, parity);
    if (!res) pgemm::epi_wait_staging(wgi);
    if constexpr (EPI == kGate) {
      const bf16* bias_s = reinterpret_cast<const bf16*>(extra);
      // 16-byte chunk c of row r at chunk c ^ (r % 8): conflict-free
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // h at column 8 j, g at 64 + 8 j
        const float2 bh = ld_bf162(bias_s + 8 * j + 2 * t4);
        const float2 bg = ld_bf162(bias_s + kBK + 8 * j + 2 * t4);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 64 * mi + 16 * warp + g + 8 * r;
            const float mlo = (acc[mi][4 * j + 2 * r] + bh.x) *
                              gelu_exact(acc[mi][4 * j + 32 + 2 * r] + bg.x);
            const float mhi =
                (acc[mi][4 * j + 2 * r + 1] + bh.y) *
                gelu_exact(acc[mi][4 * j + 32 + 2 * r + 1] + bg.y);
            *reinterpret_cast<uint32_t*>(stage + row * 128 + ((j ^ g) << 4) +
                                         4 * t4) = pack_bf16(mlo, mhi);
          }
      }
    } else {
      // y = bf16(bf16(acc) + b2), then + x rounded; box j / 4 of 32
      // columns, its 16-byte chunk c of row r at c ^ ((r / 2) % 4):
      // conflict-free
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        const float2 c2 =
            col < p.cols ? ld_bf162(p.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 64 * mi + 16 * warp + g + 8 * r;
            uint32_t* px = reinterpret_cast<uint32_t*>(
                stage + (j / 4) * BM * 64 + row * 64 +
                (((j & 3) ^ ((row >> 1) & 3)) << 4) + 4 * t4);
            float y0 = round_bf16(round_bf16(acc[mi][4 * j + 2 * r]) + c2.x);
            float y1 =
                round_bf16(round_bf16(acc[mi][4 * j + 2 * r + 1]) + c2.y);
            if (res) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(px));
              y0 += xv.x;
              y1 += xv.y;
            }
            *px = pack_bf16(y0, y1);
          }
      }
    }
    pgemm::epi_publish(wgi);
    if ((threadIdx.x & 127) == 0) {
      if constexpr (EPI == kGate) {
        sm90::tma_store_2d(tm_c, stage, n0, m0);
      } else {
        for (int b = 0; b < BN / 32; ++b)
          sm90::tma_store_2d(tm_c, stage + b * BM * 64, n0 + 32 * b, m0);
      }
      sm90::bulk_commit();
    }
  }
};

template <int EPI, int BM, int BN>
__global__ void __launch_bounds__(pgemm::kThreads, 1)
gemm_kernel(const GemmParams p, const __grid_constant__ CUtensorMap tm_a,
            const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_c,
            const __grid_constant__ CUtensorMap tm_x) {
  extern __shared__ unsigned char smem_raw[];
  const GemmOp<EPI, BM, BN> op{p, &tm_a, &tm_b, &tm_c, &tm_x};
  pgemm::run(op, smem_raw);
}

// a (rows x k) bf16 row-major tensor, boxes of 64 columns x `box_rows` in
// the 128-byte swizzle, or of 32 columns in the 64-byte one
int make_map(CUtensorMap* map, const void* base, int k, int rows,
             int box_rows, int box_cols = kBK) {
  const uint64_t dims[2] = {(uint64_t)k, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)k * 2};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return sm90_host::make_map(map, base, 2, dims, strides, box,
                             box_cols == kBK ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

// A (p.n x k), B (brows x k); `grid` persistent blocks
template <int EPI, int BM, int BN>
int launch_gemm(GemmParams p, const void* a, const void* b, int k, int brows,
                int grid, cudaStream_t stream) {
  using R = pgemm::RingOf<GemmOp<EPI, BM, BN>>;
  constexpr int kCols = GemmOp<EPI, BM, BN>::kCols;
  p.kblocks = (k + kBK - 1) / kBK;
  p.ntiles = (p.cols + kCols - 1) / kCols;
  p.tiles = ((p.n + BM - 1) / BM) * p.ntiles;
  if (grid < 1 || grid > p.tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc, tx;  // A, B, the output, the residual
  int err = make_map(&ta, a, k, p.n, BM);
  if (!err) err = make_map(&tb, b, k, brows, BN / 2);
  if (!err)
    err = make_map(&tc, p.out, p.cols, p.n, BM, EPI == kGate ? kBK : 32);
  if (err) return err;
  if (p.res != nullptr)
    err = make_map(&tx, p.res, p.cols, p.n, BM, 32);
  else
    tx = tc;
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<EPI, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kBytes);
  if (e != cudaSuccess) return (int)e;
  gemm_kernel<EPI, BM, BN><<<grid, pgemm::kThreads, R::kBytes, stream>>>(
      p, ta, tb, tc, tx);
  return (int)cudaGetLastError();
}

}  // namespace fused_ff
}  // namespace

// x (n, c), w1 (2d, c), b1 (2d), w2 (cout, d), b2 (cout), out (n, cout):
// contiguous bf16 (torch's Linear layout); lnw, lnb: fp32 (c), or both null
// (no LayerNorm: the projection reads x). Scratch from the caller: z (n, c)
// bf16 when there is a LayerNorm (else null), m (n, d) bf16. The tiles: the
// projection's rows per warpgroup tile bm1 (64 or 128) on grid1 blocks, the
// out-GEMM's bm2 x bn2 (bn2 128 or 160) on grid2 (each at most its tiles).
// c % 32 == 0, d % 64 == 0, cout % 8 == 0; the residual needs cout == c and
// the LayerNorm. Returns a cudaError_t code (0 on success).
extern "C" int tc_fused_ff(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const float* lnw,
                           const float* lnb, void* z, void* m, void* out,
                           int n, int c, int d, int cout, float eps,
                           int residual, int bm1, int grid1, int bm2, int bn2,
                           int grid2, void* stream) {
  using namespace fused_ff;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || d <= 0 || cout <= 0 || c % 32 || d % 64 ||
      cout % 8 || (residual && (cout != c || lnw == nullptr)) ||
      (lnw != nullptr && (lnb == nullptr || z == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* a1 = x;
  if (lnw != nullptr) {
    // rows of up to 768 columns stay in registers; at C = 1280 reading
    // the row twice was faster (fewer registers, more rows in flight)
    const int nch = (c + 255) / 256;
    const int e = nch == 1   ? launch_ln<1>(x, lnw, lnb, z, n, c, eps, s)
                  : nch == 2 ? launch_ln<2>(x, lnw, lnb, z, n, c, eps, s)
                  : nch == 3 ? launch_ln<3>(x, lnw, lnb, z, n, c, eps, s)
                             : launch_ln<0>(x, lnw, lnb, z, n, c, eps, s);
    if (e) return e;
    a1 = z;
  }
  GemmParams p1{};
  p1.bias = static_cast<const bf16*>(b1);
  p1.out = static_cast<bf16*>(m);
  p1.n = n;
  p1.cols = d;
  p1.d = d;
  int err;
  if (bm1 == 128)
    err = launch_gemm<kGate, 128, 128>(p1, a1, w1, c, 2 * d, grid1, s);
  else if (bm1 == 64)
    err = launch_gemm<kGate, 64, 128>(p1, a1, w1, c, 2 * d, grid1, s);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  GemmParams p2{};
  p2.bias = static_cast<const bf16*>(b2);
  p2.res = residual ? static_cast<const bf16*>(x) : nullptr;
  p2.out = static_cast<bf16*>(out);
  p2.n = n;
  p2.cols = cout;
  if (bm2 == 128 && bn2 == 160)
    return launch_gemm<kOut, 128, 160>(p2, m, w2, d, cout, grid2, s);
  if (bm2 == 128 && bn2 == 128)
    return launch_gemm<kOut, 128, 128>(p2, m, w2, d, cout, grid2, s);
  if (bm2 == 64 && bn2 == 160)
    return launch_gemm<kOut, 64, 160>(p2, m, w2, d, cout, grid2, s);
  if (bm2 == 64 && bn2 == 128)
    return launch_gemm<kOut, 64, 128>(p2, m, w2, d, cout, grid2, s);
  return (int)cudaErrorInvalidValue;
}
