// GEGLU feed-forward for Hopper (sm_90a), bf16 in and out, as three
// kernels on one stream:
//
//   (a) z = LN(x)                                ln_kernel    (N x C)
//   (b) m = (z W1h^T + b1h) gelu(z W1g^T + b1g)  proj_kernel  (N x D)
//   (c) y = m W2^T + b2 [+ x]                    out_kernel   (N x Cout)
//       or, partial (a rank's share of D under tensor parallelism), the
//       fp32 accumulator m W2^T alone: no b2, no x, no rounding
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
// (a) and (c) are the LayerNorm and the out-GEMM of ln_and_out.cuh, which
// the temporal attention shares. Design of (b) and (c): the persistent
// mainloop of persistent_gemm.cuh (a TMA ring fed by a producer thread, two
// consumer warpgroups in ping-pong on the tensor cores, column tiles
// fastest), A z, x or m, B W1 or W2 in torch's Linear layout, K-major:
//   * (b): a tile's B is 64 rows of W1's h half and the 64 rows of its
//     gate half at the same index (rows D + j), one 128-row wgmma operand,
//     so h and g of one (token, d) land in one thread's accumulator: the
//     gate (fp32 biases, brought per tile by a bulk copy, exact erff) runs
//     on registers and only m rounds; the tile goes out through shared
//     memory (swizzled, no bank conflicts) by one thread's TMA store, which
//     leaves rows past N out; rows past N arrive as zeros;
//   * (c): y = bf16(bf16(acc) + b2), then + x rounded (fused_ff.py:246-247,
//     :317), the residual tile brought by TMA while the products run.
// Tiles (chosen by the wrapper, ops/fused_ff.py `plan`): 128 rows unless
// that gives fewer tiles than SMs, then 64; (b) 64 + 64 columns, (c) 160
// where Cout allows, else 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_and_out.cuh"
#include "persistent_gemm.cuh"
#include "sm90.cuh"

namespace {
namespace fused_ff {

struct Tag;  // names this library's kernels in a trace
using pgemm::kBK;

// ---------------------------------------------------------------------------
// (b) the projection with the gate, m (N x D) = (h + b1h) gelu(g + b1g)
// ---------------------------------------------------------------------------

struct GateParams {
  const bf16* bias;  // b1 (2d)
  bf16* out;         // m (n, d)
  int n;             // token rows
  int d;             // m's columns; the gate rows' offset in W1
  int kblocks;       // ceil(C / 64)
  int ntiles;        // column tiles
  int tiles;         // row tiles x column tiles
};

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// BM rows x 128 accumulator columns a warpgroup tile: the output tile is 64
// columns of m (accumulator columns 0-63 h, 64-127 g). The staging area
// holds it (BM x 64 of m, one 128-byte-swizzled box), the extra area its
// 64 + 64 biases. tm_c: m as the stores see it.
template <int BM>
struct GateOp {
  static constexpr int kBM = BM, kBN = 128;
  static constexpr int kStaging = BM * kBK * 2;
  static constexpr int kExtra = 2 * kBK * 2;
  GateParams p;
  const CUtensorMap* tm_a;
  const CUtensorMap* tm_b;
  const CUtensorMap* tm_c;

  // the tile's first row and first column of m (the h rows of W1 there,
  // the gate rows D further)
  struct Tile {
    int m0, n0;
  };

  __device__ __forceinline__ Tile tile(int t) const {
    return {(t / p.ntiles) * BM, (t % p.ntiles) * kBK};
  }
  __device__ __forceinline__ int tiles() const { return p.tiles; }
  __device__ __forceinline__ int kblocks() const { return p.kblocks; }

  // A's rows m0..; B's 128 rows as the h rows n0.. and the gate rows D + n0..
  __device__ __forceinline__ void load(void* a, void* b, uint64_t* bar,
                                       const Tile& c, int kb) const {
    unsigned char* sb = static_cast<unsigned char*>(b);
    sm90::tma_load_2d(a, tm_a, bar, kb * kBK, c.m0);
    sm90::tma_load_2d(sb, tm_b, bar, kb * kBK, c.n0);
    sm90::tma_load_2d(sb + kBN * kBK, tm_b, bar, kb * kBK, p.d + c.n0);
  }

  // the tile's h and g biases
  __device__ __forceinline__ void before(const Tile& c, unsigned char*,
                                         unsigned char* extra,
                                         uint64_t* xbar) const {
    bf16* bias_s = reinterpret_cast<bf16*>(extra);
    sm90::mbar_expect_tx(xbar, kExtra);
    sm90::bulk_load(bias_s, p.bias + c.n0, 2 * kBK, xbar);
    sm90::bulk_load(bias_s + kBK, p.bias + p.d + c.n0, 2 * kBK, xbar);
  }

  // m into the staging area (16-byte chunk c of row r at chunk c ^ (r % 8):
  // conflict-free); one thread stores it by TMA
  __device__ __forceinline__ void epilogue(float (&acc)[BM / 64][kBN / 2],
                                           const Tile& c, int parity,
                                           int wgi, unsigned char* stage,
                                           unsigned char* extra,
                                           uint64_t* xbar) const {
    constexpr int kMT = BM / 64;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2, t4 = lane & 3;
    sm90::mbar_wait(xbar, parity);
    pgemm::epi_wait_staging(wgi);
    const bf16* bias_s = reinterpret_cast<const bf16*>(extra);
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
          const float mhi = (acc[mi][4 * j + 2 * r + 1] + bh.y) *
                            gelu_exact(acc[mi][4 * j + 32 + 2 * r + 1] + bg.y);
          *reinterpret_cast<uint32_t*>(stage + row * 128 + ((j ^ g) << 4) +
                                       4 * t4) = pack_bf16(mlo, mhi);
        }
    }
    pgemm::epi_publish(wgi);
    if ((threadIdx.x & 127) == 0) {
      sm90::tma_store_2d(tm_c, stage, c.n0, c.m0);
      sm90::bulk_commit();
    }
  }
};

template <int BM>
__global__ void __launch_bounds__(pgemm::kThreads, 1)
proj_kernel(const GateParams p, const __grid_constant__ CUtensorMap tm_a,
            const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_c) {
  extern __shared__ unsigned char smem_raw[];
  const GateOp<BM> op{p, &tm_a, &tm_b, &tm_c};
  pgemm::run(op, smem_raw);
}

// A (n x c), W1 (2d x c); `grid` persistent blocks
template <int BM>
int launch_proj(GateParams p, const void* a, const void* w1, int c, int grid,
                cudaStream_t stream) {
  using R = pgemm::RingOf<GateOp<BM>>;
  p.kblocks = (c + kBK - 1) / kBK;
  p.ntiles = p.d / kBK;
  p.tiles = ((p.n + BM - 1) / BM) * p.ntiles;
  if (grid < 1 || grid > p.tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc;  // A, W1, m
  int err = lnout::make_map(&ta, a, c, p.n, BM);
  if (!err) err = lnout::make_map(&tb, w1, c, 2 * p.d, kBK);
  if (!err) err = lnout::make_map(&tc, p.out, p.d, p.n, BM);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      proj_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kBytes);
  if (e != cudaSuccess) return (int)e;
  proj_kernel<BM><<<grid, pgemm::kThreads, R::kBytes, stream>>>(p, ta, tb,
                                                                 tc);
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
// the LayerNorm. partial: out is (n, cout) fp32, the out-GEMM's accumulator
// (b2 unused, no residual); w1 then holds a rank's value rows and its gate
// rows (2 d of them, d the rank's share of D) and w2 its d columns. Returns
// a cudaError_t code (0 on success).
extern "C" int tc_fused_ff(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const float* lnw,
                           const float* lnb, void* z, void* m, void* out,
                           int n, int c, int d, int cout, float eps,
                           int residual, int partial, int bm1, int grid1,
                           int bm2, int bn2, int grid2, void* stream) {
  using namespace fused_ff;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || d <= 0 || cout <= 0 || c % 32 || d % 64 ||
      cout % 8 || (residual && (cout != c || lnw == nullptr || partial)) ||
      (lnw != nullptr && (lnb == nullptr || z == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* a1 = x;
  if (lnw != nullptr) {
    const int e = lnout::launch_ln<Tag>(x, lnw, lnb, z, n, c, eps, s);
    if (e) return e;
    a1 = z;
  }
  GateParams p1{};
  p1.bias = static_cast<const bf16*>(b1);
  p1.out = static_cast<bf16*>(m);
  p1.n = n;
  p1.d = d;
  int err;
  if (bm1 == 128)
    err = launch_proj<128>(p1, a1, w1, c, grid1, s);
  else if (bm1 == 64)
    err = launch_proj<64>(p1, a1, w1, c, grid1, s);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  if (partial)
    return lnout::launch_out_partial<Tag>(m, w2, static_cast<float*>(out), n,
                                          d, cout, bm2, bn2, grid2, s);
  return lnout::launch_out<Tag>(m, w2, b2, residual ? x : nullptr, out, n, d,
                                cout, bm2, bn2, grid2, s);
}
