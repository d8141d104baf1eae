// GroupNorm (+SiLU) over each sample of a channels-last (N, HW, C) bf16
// tensor, for Hopper (sm_90a), in one launch. Replaces the TPU kernel
// tooncrafter_tpu/ops/fused_norms.py::_pallas_gn, with its rounding:
//
//   s1[c] = sum over HW of x,   s2[c] = sum over HW of bf16(x * x)  (fp32)
//   per group g: mean = S1 / n, var = max(S2 / n - mean^2, 0), n = HW C / G
//   A[c] = rsqrt(var + eps) * scale[c],   B[c] = bias[c] - mean A[c]
//   y = x A + B in fp32, then y * sigmoid(y) in fp32 when silu, rounded once
//   (the sigmoid's exponential and reciprocal approximate: a few fp32 ulps)
//
// The TPU kernel holds one sample (<= 4 MiB) in VMEM and reads it once.
// Blocks on Hopper cannot wait for each other, but the blocks of one thread
// block cluster are scheduled together and read each other's shared
// memory. So a sample is one cluster of k <= 16 blocks (the plan:
// ops/fused_norms.plan), and block `rank` of it, with rows [rank * rows,
// (rank + 1) * rows) of the sample:
//   1. streams its slice into shared memory by bulk copies (row_sums.cuh)
//      and keeps it there, taking the column sums as the stages land;
//   2. folds them per channel, then per group, into (S1, S2) partials in
//      its shared memory;
//   3. meets the cluster at a barrier and reads the k ranks' partials
//      through distributed shared memory (mapa / ld.shared::cluster) in
//      rank order, so every block holds the same statistics bit for bit;
//      then arrives on a second cluster barrier, which it waits on just
//      before it exits: no block leaves while a peer may still read it;
//   4. folds the affine into (A, B) for its columns and writes y from the
//      resident slice, 16-byte stores.
// x is read once and y written once, the bound's bytes. Where no slice
// fits shared memory (a sample above ~3.4 MB), or where resident slices
// would hold one block an SM and the batch several waves, the slice
// streams through a ring of four stages twice instead, the second read
// from L2 where the sample still is. No float atomics: two calls agree bit
// for bit. What bounds it on the H100: 4 bytes an element against ~12
// operations, so the bytes.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "row_sums.cuh"

namespace {

using Square = rowsums::SquareBf16;  // the TPU kernel squares in x's dtype

constexpr int kMaxThreads = 1024;    // 16-byte columns x row offsets
constexpr int kMaxSmem = 232448;     // a block's shared memory on the H100

// the block's shared memory (ops/fused_norms.plan sums the same): the
// mbarriers; this block's group partials (2 G floats); the channel sums,
// then the cluster's totals (2 C); the row offsets' fold, then (A, B)
// (max(rstep, 2) C); the slice or the ring
struct Layout {
  int grp, csum, red, data, total;
  __host__ __device__ Layout(int c, int groups, int rstep, long long bytes) {
    grp = rowsums::kBarBytes;
    csum = grp + (8 * groups + 15) / 16 * 16;
    red = csum + 8 * c;
    data = (red + 4 * (rstep > 2 ? rstep : 2) * c + 127) / 128 * 128;
    total = bytes > kMaxSmem ? kMaxSmem + 1 : data + (int)bytes;
  }
};

template <bool kResident>
__global__ void __launch_bounds__(kMaxThreads)
    gn_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, bf16* __restrict__ out, int hw,
              int c, int groups, int k, int rows, int stage_rows, int slots,
              float eps, int silu) {
  extern __shared__ __align__(128) char smem[];
  const int cv = c / 8, rstep = blockDim.x / cv;
  const Layout lay(c, groups, rstep, 0);
  float* grp = reinterpret_cast<float*>(smem + lay.grp);
  float* csum = reinterpret_cast<float*>(smem + lay.csum);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  rowsums::Ring ring = rowsums::ring_init(reinterpret_cast<uint64_t*>(smem),
                                          smem + lay.data);
  const int rank = (int)sm90::cluster_rank();
  const int r0 = rank * rows, r1 = min(hw, r0 + rows);
  const long long base = ((long long)(blockIdx.x / k) * hw + r0) * c;
  const long long bytes = r1 > r0 ? 2ll * (r1 - r0) * c : 0;
  const char* src = reinterpret_cast<const char*>(x + base);
  const int stage = 2 * stage_rows * c;

  // 1. the slice's column sums as its stages land
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  rowsums::stream(ring, src, bytes, stage, slots,
                  [&](const char* st, int, int nb) {
                    rowsums::add_rows<bf16, Square>(st, nb, s1, s2);
                  });

  // 2. per channel, then per group, in order
  rowsums::fold_columns<8>(s1, red, c, rstep, csum);
  rowsums::fold_columns<8>(s2, red, c, rstep, csum + c);
  const int cg = c / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += csum[g * cg + j];
      b += csum[c + g * cg + j];
    }
    grp[g] = a;
    grp[groups + g] = b;
  }

  // 3. the k ranks' partials, in rank order, through distributed shared
  // memory; the totals over the channel sums
  sm90::cluster_sync();
  for (int i = threadIdx.x; i < 2 * groups; i += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < k; ++r)
      t += sm90::ld_peer_f32(sm90::peer_addr(&grp[i], r));
    csum[i] = t;
  }
  sm90::cluster_arrive();
  __syncthreads();

  // 4. (A, B) per channel, then y for the slice
  const float cnt = (float)hw * (float)cg;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    const float mean = csum[g] / cnt;
    const float var = fmaxf(csum[groups + g] / cnt - mean * mean, 0.f);
    const float inv = 1.f / sqrtf(var + eps);
    const float A = inv * scale[ch];
    red[ch] = A;
    red[c + ch] = bias[ch] - mean * A;
  }
  __syncthreads();
  const int c0 = (threadIdx.x % cv) * 8;
  float fa[8], fb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    fa[j] = red[c0 + j];
    fb[j] = red[c + c0 + j];
  }
  char* dst = reinterpret_cast<char*>(out + base);
  auto apply = [&](const char* st, int s, int nb) {
    const uint4* p = reinterpret_cast<const uint4*>(st);
    uint4* q = reinterpret_cast<uint4*>(dst + (long long)s * stage);
#pragma unroll 4
    for (int i = threadIdx.x; i < nb / 16; i += blockDim.x) {
      const uint4 u = p[i];
      uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
        float y0 = f.x * fa[2 * j] + fb[2 * j];
        float y1 = f.y * fa[2 * j + 1] + fb[2 * j + 1];
        if (silu) {
          y0 = fast_silu(y0);
          y1 = fast_silu(y1);
        }
        w[j] = pack_bf16(y0, y1);
      }
      q[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  };
  if (kResident)
    apply(ring.buf, 0, (int)bytes);
  else
    rowsums::stream(ring, src, bytes, stage, slots, apply);
  sm90::cluster_wait();
}

template <bool kResident>
int launch(const bf16* x, const float* scale, const float* bias, bf16* out,
           int n, int hw, int c, int groups, int k, int rows, int stage_rows,
           int slots, int threads, int smem, float eps, int silu,
           cudaStream_t stream) {
  auto kernel = gn_kernel<kResident>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * k);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, scale, bias, out, hw, c, groups, k,
                         rows, stage_rows, slots, eps, silu);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: contiguous bf16 (n, hw, c); scale, bias: fp32 (c). The plan
// (ops/fused_norms.plan): k blocks a sample (a cluster; 1, 2, 4, 8 or 16),
// `rows` rows a block, every block's rows non-empty; c / 8 x rstep threads
// a block (rstep row offsets); stages of stage_rows rows (whole groups of
// rstep rows); `slots` of them in shared memory: the whole slice
// (resident) when slots * stage_rows >= rows, else a ring the slice
// streams through twice. c % 8 == 0, c % groups == 0. Returns a
// cudaError_t code (0 on success).
extern "C" int tc_group_norm_silu(const void* x, const float* scale,
                                  const float* bias, void* out, int n, int hw,
                                  int c, int groups, int k, int rows,
                                  int rstep, int stage_rows, int slots,
                                  float eps, int silu, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || c % 8 || rstep <= 0 ||
      c / 8 * rstep > kMaxThreads ||
      groups <= 0 || c % groups || (k != 1 && k != 2 && k != 4 && k != 8 &&
                                    k != 16) ||
      rows <= 0 || (long long)rows * k < hw ||
      (long long)rows * (k - 1) >= hw || (long long)n * k > 0x7fffffff ||
      slots <= 0 || slots > rowsums::kMaxSlots || stage_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  if (stage_rows % rstep) return (int)cudaErrorInvalidValue;
  const bool resident = (long long)slots * stage_rows >= rows;
  const Layout lay(c, groups, rstep,
                   2ll * c * (resident ? rows : (long long)slots * stage_rows));
  if (lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resident
             ? launch<true>(xb, scale, bias, ob, n, hw, c, groups, k, rows,
                            stage_rows, slots, cv * rstep, lay.total, eps,
                            silu, s)
             : launch<false>(xb, scale, bias, ob, n, hw, c, groups, k, rows,
                             stage_rows, slots, cv * rstep, lay.total, eps,
                             silu, s);
}

// Clusters of a plan's blocks (k blocks of `threads` threads and `smem`
// bytes of shared memory) that the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t code: what
// ops/fused_norms.CLUSTERS_AT_ONE_AN_SM records for the H100.
extern "C" int tc_gn_clusters(int k, int threads, int smem, int resident) {
  auto kernel = resident ? gn_kernel<true> : gn_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}
