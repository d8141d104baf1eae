// The persistent, warp-specialised wgmma GEMM mainloop for Hopper
// (sm_90a) that the GEMM kernels share (fused_ff.cu's projection,
// ln_and_out.cuh's out-GEMM, temporal_conv.cu's three-tap GEMM,
// temporal_attention.cu's q|k|v GEMM): D (BM x BN tiles) = A (rows x K) B
// (cols x K)^T, bf16 operands, fp32 accumulators.
//
// A persistent grid of one block an SM walks output tiles blockIdx.x + i
// gridDim.x (the order of the tile index is the caller's: column tiles
// fastest reads a row tile of A from L2 for consecutive tiles):
//   * a producer thread brings each tile's A rows and B rows in K blocks
//     of 64 columns by TMA (128-byte swizzle) into a ring of stages on
//     mbarriers; where they come from is the caller's (`Op::load`), so a
//     K block may be any box of any tensor map (the temporal conv's
//     shifted taps);
//   * two consumer warpgroups take the block's tiles in turns (ping-pong):
//     each runs wgmma from shared memory into its own fp32 accumulator of
//     BM x BN (BM = 64 or 128 rows: one or two m64 products), and a named
//     barrier hands the tensor cores to the other once its last product
//     is issued, so one warpgroup's epilogue runs while the other's
//     products do; or, for an Op with kCoop (BM = 128), both take every
//     tile, each its 64-row half of A with the one B (a K block of the
//     ring feeds 128 x BN products, at the price of both epilogues at
//     once);
//   * each consumer warpgroup owns a staging area (`Op::kStaging` bytes,
//     1024-byte aligned: the output tile on its way out by TMA) and
//     `Op::kExtra` bytes more (e.g. biases), and an mbarrier for the
//     epilogue's own loads; `Op::before` (one thread, before the tile's
//     products) starts those loads, `Op::epilogue` (the whole warpgroup,
//     after them) writes the tile out. `epi_wait_staging` and
//     `epi_publish` are the two handshakes an epilogue needs around its
//     staging area.
//
// Op: kBM, kBN, kStaging, kExtra (and kCoop, false unless given); a type
//   Tile, a tile's coordinates, and
//   Tile tile(int t) const (computed once a tile, so the producer's issue
//   of a K block is its TMA calls alone); int tiles() const; int kblocks()
//   const;
//   void load(void* a, void* b, uint64_t* bar, const Tile&, int kb) const
//     (the producer: the TMA loads of K block kb, BM x 64 into a, BN x 64
//     into b, completing on bar; the ring expects kStage bytes);
//   void before(const Tile&, unsigned char* staging, unsigned char* extra,
//     uint64_t* xbar) const (one thread of the warpgroup);
//   void epilogue(float (&acc)[MT][BN / 2], const Tile&, int parity,
//     int wgi, unsigned char* staging, unsigned char* extra, uint64_t* xbar)
//     const (the warpgroup; xbar's phase of this tile is `parity`; MT = BM
//     / 64, or 1 with kCoop).
// Thread (warp w of the warpgroup, lane l; g = l / 4, t4 = l % 4) holds
// acc[mi][4 j + e] at row 64 mi + 16 w + g + 8 (e / 2), column 8 j + 2 t4 +
// (e % 2) of the tile (sm90.cuh); with kCoop, of its warpgroup's half.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace pgemm {

constexpr int kBK = 64;        // K columns a stage: one 128-byte swizzle row
constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kOrderBar = 1;   // named barriers 1, 2: whose turn on the
                               // tensor cores (0 is __syncthreads)
constexpr int kEpiBar = 3;     // 3, 4: each consumer warpgroup's epilogue

// Shared memory: the ring's stages of [A: BM x 64][B: BN x 64] (every tile
// a whole number of 1024-byte swizzle atoms, as many stages as fit, at most
// 8), the two staging areas, the two extra areas, then the barriers.
template <int BM, int BN, int kStaging, int kExtra>
struct Ring {
  static constexpr int kA = BM * kBK * 2;
  static constexpr int kB = BN * kBK * 2;
  static constexpr int kStage = kA + kB;
  static constexpr int kFit =
      (227 * 1024 - 2048 - 2 * (kStaging + kExtra)) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kStagingOffset = kStages * kStage;
  static constexpr int kExtraOffset = kStagingOffset + 2 * kStaging;
  static constexpr int kBarOffset = kExtraOffset + 2 * kExtra;
  static constexpr int kBytes = kBarOffset + (2 * kStages + 2) * 8 + 1024;
  static_assert(kStaging % 1024 == 0, "staging areas stay 1024-aligned");
};

template <class Op>
using RingOf = Ring<Op::kBM, Op::kBN, Op::kStaging, Op::kExtra>;

// Op::kCoop where the Op gives it, else false
template <class Op, class = void>
struct CoopOf {
  static constexpr bool value = false;
};
template <class Op>
struct CoopOf<Op, std::void_t<decltype(Op::kCoop)>> {
  static constexpr bool value = Op::kCoop;
};

// one m64 x BN x k16 product from shared memory, both operands K-major
template <int BN>
__device__ __forceinline__ void mma_ss(float (&d)[BN / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(BN == 128 || BN == 160 || BN == 192,
                "wgmma widths of the GEMMs");
  if constexpr (BN == 128)
    sm90::wgmma_m64n128k16_ss<0>(d, da, db, scale_d);
  else if constexpr (BN == 160)
    sm90::wgmma_m64n160k16_ss(d, da, db, scale_d);
  else
    sm90::wgmma_m64n192k16_ss(d, da, db, scale_d);
}

// the staging area is free: the previous tile's TMA store has read it, and
// every thread of the warpgroup is past the previous epilogue
__device__ __forceinline__ void epi_wait_staging(int wgi) {
  if ((threadIdx.x & 127) == 0) sm90::bulk_wait_read<0>();
  sm90::bar_sync(kEpiBar + wgi, 128);
}

// the warpgroup's writes to the staging area are visible to the TMA store
__device__ __forceinline__ void epi_publish(int wgi) {
  sm90::fence_async_smem();
  sm90::bar_sync(kEpiBar + wgi, 128);
}

// The kernel body; smem_raw: the kernel's dynamic shared memory of
// RingOf<Op>::kBytes, launched with kThreads threads.
template <class Op>
__device__ __forceinline__ void run(const Op& op, unsigned char* smem_raw) {
  using R = RingOf<Op>;
  constexpr int BN = Op::kBN;
  constexpr bool kCoop = CoopOf<Op>::value;
  static_assert(!kCoop || Op::kBM == 128, "a 64-row half a warpgroup");
  constexpr int kMT = kCoop ? 1 : Op::kBM / 64;  // m64 products
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + R::kBarOffset);
  uint64_t* empty = full + R::kStages;
  uint64_t* xbar = empty + R::kStages;  // each warpgroup's epilogue loads
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int tiles = op.tiles(), kblocks = op.kblocks();
  const int my_tiles =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      // one arrival per consumer warp that reads the stage
      sm90::mbar_init(&empty[s], kCoop ? 8 : 4);
    }
    sm90::mbar_init(&xbar[0], 1);
    sm90::mbar_init(&xbar[1], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      int it = 0;
      for (int i = 0; i < my_tiles; ++i) {
        const typename Op::Tile c = op.tile(blockIdx.x + i * gridDim.x);
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % R::kStages;
          sm90::mbar_wait(&empty[s], ((it / R::kStages) & 1) ^ 1);
          unsigned char* st = base + s * R::kStage;
          sm90::mbar_expect_tx(&full[s], R::kStage);
          op.load(st, st + R::kA, &full[s], c, kb);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  float acc[kMT][BN / 2];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[mi][e] = 0.f;

  // the products of K block `kb` of the ring's step `it`
  auto issue = [&](int it, int kb) {
    const int s = it % R::kStages;
    sm90::mbar_wait(&full[s], (it / R::kStages) & 1);
    const uint64_t da = sm90::desc_sw128(base + s * R::kStage +
                                         (kCoop ? wgi * 64 * 128 : 0));
    const uint64_t db = sm90::desc_sw128(base + s * R::kStage + R::kA);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) sm90::fence_regs(acc[mi]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        mma_ss<BN>(acc[mi], sm90::desc_add(da, mi * 64 * 128 + 32 * kk),
                   sm90::desc_add(db, 32 * kk), kb > 0 || kk > 0);
    sm90::wgmma_commit();
  };
  auto release = [&](int it) {
    if (lane == 0) sm90::mbar_arrive(&empty[it % R::kStages]);
  };

  unsigned char* staging = base + R::kStagingOffset + wgi * Op::kStaging;
  unsigned char* extra = base + R::kExtraOffset + wgi * Op::kExtra;
  for (int i = kCoop ? 0 : wgi, lt = 0; i < my_tiles;
       i += kCoop ? 1 : 2, ++lt) {
    const typename Op::Tile c = op.tile(blockIdx.x + i * gridDim.x);
    // this warpgroup's turn on the tensor cores: the other has issued the
    // products of the block's previous tile
    if (!kCoop && i > 0) sm90::bar_sync(kOrderBar + wgi, 256);
    if (leader) op.before(c, staging, extra, &xbar[wgi]);
    int it = i * kblocks;
    issue(it, 0);
    for (int kb = 1; kb < kblocks; ++kb) {
      issue(++it, kb);
      sm90::wgmma_wait<1>();
      release(it - 1);
    }
    if (!kCoop && i + 1 < my_tiles)
      sm90::bar_arrive(kOrderBar + (wgi ^ 1), 256);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) sm90::fence_regs(acc[mi]);
    release(it);
    op.epilogue(acc, c, lt & 1, wgi, staging, extra, &xbar[wgi]);
  }
  if (leader) sm90::bulk_wait<0>();  // the last store is out
}

}  // namespace pgemm
