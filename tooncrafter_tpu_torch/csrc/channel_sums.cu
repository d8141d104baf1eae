// Per-channel sums of a channels-last (N, S, C) tensor for Hopper (sm_90a),
// in one launch: s1[n, c] = sum over S of x, s2[n, c] = sum over S of x^2,
// in fp32, with x cast to fp32 before it is squared. Replaces the TPU
// kernel tooncrafter_tpu/ops/stats.py::_pallas_sums, which sums spatial
// tiles into per-tile partials that a small XLA sum folds.
//
// The grid is the whole card (ops/stats.plan): block (chunk, n) streams a
// chunk of rows of sample n through a ring of bulk copies in shared memory
// (row_sums.cuh) and takes its column sums, fp32 squares. It writes its
// (2, C) partial to scratch, fences, and adds one to sample n's arrival
// counter (atom.add.acq_rel.gpu). The block that arrives last for a sample
// streams that sample's partials through its ring and adds them, each
// channel in chunk order, into s1 and s2; then it sets the counter back to
// 0 for the next launch. One launch, no float atomics: the result does not
// depend on which block arrives last, and two calls agree bit for bit.
// What bounds it on the H100: each element is read once for three fp32
// operations, so the bytes (N S C itemsize / 3.35 TB/s; 52 MB, ~16 us, at
// the UNet's largest GroupNorm input).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_sums.cuh"

namespace {

using Square = rowsums::SquareF32;  // x cast to fp32, then squared

constexpr int kMaxThreads = 1024;   // 16-byte columns x row offsets
constexpr int kMaxSmem = 232448;    // a block's shared memory on the H100
constexpr int kFold4 = 4;           // float4 partial columns a thread folds

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    sums_kernel(const T* __restrict__ x, float* __restrict__ part,
                float* __restrict__ s1, float* __restrict__ s2,
                int* __restrict__ counters, int s, int c, int rows,
                int stage_rows, int slots, int fold_rows, int fold_slots) {
  constexpr int V = rowsums::Vec<T>::n;
  extern __shared__ __align__(128) char smem[];
  __shared__ int last;
  rowsums::Ring ring = rowsums::ring_init(reinterpret_cast<uint64_t*>(smem),
                                          smem + rowsums::kBarBytes);
  const int rstep = blockDim.x / (c / V);
  const int n = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int r0 = chunk * rows, r1 = min(s, r0 + rows);
  const long long base = ((long long)n * s + r0) * c;
  const long long row_bytes = (long long)c * sizeof(T);

  // the chunk's column sums
  float a1[V], a2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
  rowsums::stream(ring, reinterpret_cast<const char*>(x + base),
                  (r1 - r0) * row_bytes, (int)(stage_rows * row_bytes), slots,
                  [&](const char* st, int, int nb) {
                    rowsums::add_rows<T, Square>(st, nb, a1, a2);
                  });
  __syncthreads();  // the ring's memory is free for the fold
  float* red = reinterpret_cast<float*>(ring.buf);
  float* mine = part + ((long long)n * chunks + chunk) * 2 * c;
  rowsums::fold_columns<V>(a1, red, c, rstep, mine);
  rowsums::fold_columns<V>(a2, red, c, rstep, mine + c);

  // publish the partial; the last block of sample n goes on (its ring,
  // written by the fold above, is refilled by bulk copies: the async proxy)
  __threadfence();
  sm90::fence_async_global();
  sm90::fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0)
    last = sm90::atom_add_acq_rel(&counters[n], 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) sm90::fence_async_global();

  // the sample's partials, each of the 2 C columns in chunk order: thread
  // t adds the float4 columns t, t + T, ... of each chunk's row
  const int cols = 2 * c, cols4 = c / 2;
  float4 acc[kFold4];
#pragma unroll
  for (int q = 0; q < kFold4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  rowsums::stream(
      ring, reinterpret_cast<const char*>(part + (long long)n * chunks * cols),
      4ll * chunks * cols, 4 * fold_rows * cols, fold_slots,
      [&](const char* st, int, int nb) {
        const float4* p = reinterpret_cast<const float4*>(st);
        for (int r = 0; r < nb / (4 * cols); ++r) {
#pragma unroll
          for (int q = 0; q < kFold4; ++q) {
            const int j = threadIdx.x + q * blockDim.x;
            if (j < cols4) {
              const float4 v = p[r * cols4 + j];
              acc[q].x += v.x;
              acc[q].y += v.y;
              acc[q].z += v.z;
              acc[q].w += v.w;
            }
          }
        }
      });
#pragma unroll
  for (int q = 0; q < kFold4; ++q) {
    const int j = 4 * (threadIdx.x + q * blockDim.x);  // c % 4 == 0
    if (j < cols)
      *reinterpret_cast<float4*>(j < c ? s1 + (long long)n * c + j
                                       : s2 + (long long)n * c + j - c) =
          acc[q];
  }
  if (threadIdx.x == 0) counters[n] = 0;
}

template <typename T>
int launch(const T* x, float* part, float* s1, float* s2, int* counters,
           int n, int s, int c, int chunks, int rows, int rstep,
           int stage_rows, int slots, int fold_rows, int fold_slots,
           cudaStream_t stream) {
  constexpr int V = rowsums::Vec<T>::n;
  if (c % V || c / V * rstep > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = c / V * rstep;
  const long long row_bytes = (long long)c * sizeof(T);
  const long long data = slots * stage_rows * row_bytes;
  const long long fold = (long long)fold_slots * fold_rows * 8 * c;
  // the ring (beside the mbarriers and the static `last`) holds the fold
  // of the row offsets (rstep c floats) and the partials' stages; every
  // thread folds at most kFold4 float4 columns of the 2 c
  if (stage_rows % rstep || data > kMaxSmem - rowsums::kBarBytes - 128 ||
      fold > data || 4ll * rstep * c > data || c / 2 > kFold4 * threads)
    return (int)cudaErrorInvalidValue;
  const int smem = rowsums::kBarBytes + (int)data;
  cudaError_t e = cudaFuncSetAttribute(
      sums_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sums_kernel<T><<<dim3(chunks, n), threads, smem, stream>>>(
      x, part, s1, s2, counters, s, c, rows, stage_rows, slots, fold_rows,
      fold_slots);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (n, s, c) of dtype 0 = bf16, 1 = fp16, 2 = fp32; part: fp32
// scratch of n * chunks * 2 * c; s1, s2: fp32 (n, c), written; counters:
// n int32 zeros, left zero. The plan (ops/stats.plan): chunks of `rows`
// rows, every chunk non-empty; (16-byte columns of c) x rstep threads a
// block; stages of stage_rows rows (whole groups of rstep rows), `slots`
// in flight; the partials' fold in stages of fold_rows chunks, fold_slots
// in flight. c times the element size a multiple of 16 bytes. Returns a
// cudaError_t code.
extern "C" int tc_channel_sums(const void* x, float* part, float* s1,
                               float* s2, int* counters, int n, int s, int c,
                               int chunks, int rows, int rstep,
                               int stage_rows, int slots, int fold_rows,
                               int fold_slots, int dtype, void* stream) {
  if (n <= 0 || s <= 0 || c <= 0 || chunks <= 0 || n > 65535 || rstep <= 0 ||
      chunks > 0x7fffffff / 2 || rows <= 0 || (long long)rows * chunks < s ||
      (long long)rows * (chunks - 1) >= s || stage_rows <= 0 ||
      slots <= 0 || slots > rowsums::kMaxSlots || fold_rows <= 0 ||
      fold_slots <= 0 || fold_slots > rowsums::kMaxSlots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const __nv_bfloat16*>(x), part, s1, s2,
                  counters, n, s, c, chunks, rows, rstep, stage_rows, slots,
                  fold_rows, fold_slots, st);
  if (dtype == 1)
    return launch(static_cast<const __half*>(x), part, s1, s2, counters, n,
                  s, c, chunks, rows, rstep, stage_rows, slots, fold_rows,
                  fold_slots, st);
  if (dtype == 2)
    return launch(static_cast<const float*>(x), part, s1, s2, counters, n, s,
                  c, chunks, rows, rstep, stage_rows, slots, fold_rows,
                  fold_slots, st);
  return (int)cudaErrorInvalidValue;
}
