// Per-channel sums of a channels-last (N, S, C) tensor for Hopper (sm_90a):
// s1[n, c] = sum over S of x, s2[n, c] = sum over S of x^2, in fp32, with x
// cast to fp32 before it is squared. Replaces the TPU kernel
// tooncrafter_tpu/ops/stats.py::_pallas_sums, which sums spatial tiles
// into per-tile partials that a small XLA sum folds.
//
// The same two passes, as two launches of one call:
//   1. partial sums: block (chunk, n) reads a chunk of rows of sample n,
//      each thread one 16-byte column of channels (neighbouring threads on
//      neighbouring addresses), several rows at once; the threads of a
//      column fold through shared memory in a fixed order and the block
//      writes (n, chunk, 2, C) fp32;
//   2. fold: one thread per (n, c) adds the partials over the chunks, in
//      order, into s1 and s2.
// No atomics: a run is deterministic. What bounds it on the H100: each
// element is read once for three fp32 operations, so the bytes do
// (N S C itemsize / 3.35 TB/s; 52 MB, ~16 us, at the UNet's largest
// GroupNorm input).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFoldThreads = 256;
constexpr int kRowThreads = 256;  // threads a block aims for

// x cast to fp32, then squared in fp32
__device__ __forceinline__ float sq(float v) { return v * v; }

// 16 bytes of x as floats: 8 bf16 / fp16 values or 4 fp32 values
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t wj = w[j];
      const float2 p = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&wj));
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
};
template <> struct Vec<__half> {
  static constexpr int n = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t wj = w[j];
      const float2 p = __half22float2(*reinterpret_cast<__half2*>(&wj));
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <typename T>
__global__ void sums_partial(const T* __restrict__ x, float* __restrict__ part,
                             int s, int c, int rows, int rstep) {
  constexpr int V = Vec<T>::n;
  extern __shared__ float sred[];  // [rstep][2][c]
  const int cv = c / V;
  const int v = threadIdx.x % cv, ro = threadIdx.x / cv;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * rows, r1 = min(s, r0 + rows);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  const T* xs = x + (long long)n * s * c + v * V;
  for (int r = r0 + ro; r < r1; r += rstep) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(xs + (long long)r * c));
    float f[V];
    Vec<T>::load(u, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1[i] += f[i];
      s2[i] += sq(f[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sred[(ro * 2) * c + v * V + i] = s1[i];
    sred[(ro * 2 + 1) * c + v * V + i] = s2[i];
  }
  __syncthreads();
  float* dst = part + (((long long)n * gridDim.x + chunk) * 2) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rstep; ++k) {
      a += sred[(k * 2) * c + ch];
      b += sred[(k * 2 + 1) * c + ch];
    }
    dst[ch] = a;
    dst[c + ch] = b;
  }
}

__global__ void __launch_bounds__(kFoldThreads)
    sums_fold(const float* __restrict__ part, float* __restrict__ s1,
              float* __restrict__ s2, int c, int chunks) {
  const int n = blockIdx.y;
  const int ch = blockIdx.x * kFoldThreads + threadIdx.x;
  if (ch >= c) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float* src = part + (((long long)n * chunks + k) * 2) * c;
    a += src[ch];
    b += src[c + ch];
  }
  s1[(long long)n * c + ch] = a;
  s2[(long long)n * c + ch] = b;
}

template <typename T>
int launch(const T* x, float* part, float* s1, float* s2, int n, int s, int c,
           int chunks, cudaStream_t stream) {
  const int cv = c / Vec<T>::n;
  if (c % Vec<T>::n || cv > 1024) return (int)cudaErrorInvalidValue;
  const int rows = (s + chunks - 1) / chunks;
  const int rstep = cv >= kRowThreads ? 1 : kRowThreads / cv;
  const int smem = rstep * 2 * c * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sums_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sums_partial<T><<<dim3(chunks, n), cv * rstep, smem, stream>>>(
      x, part, s, c, rows, rstep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_fold<<<dim3((c + kFoldThreads - 1) / kFoldThreads, n), kFoldThreads, 0,
              stream>>>(part, s1, s2, c, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (n, s, c) of dtype 0 = bf16, 1 = fp16, 2 = fp32; part: fp32
// scratch of n * chunks * 2 * c; s1, s2: fp32 (n, c), written. c times the
// element size a multiple of 16 bytes and at most 1024 such columns; every
// chunk of ceil(s / chunks) rows non-empty. Returns a cudaError_t code.
extern "C" int tc_channel_sums(const void* x, float* part, float* s1, float* s2,
                               int n, int s, int c, int chunks, int dtype,
                               void* stream) {
  if (n <= 0 || s <= 0 || c <= 0 || chunks <= 0 || chunks > s ||
      n > 65535 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = (s + chunks - 1) / chunks;
  if ((long long)rows * (chunks - 1) >= s) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const __nv_bfloat16*>(x), part, s1, s2, n, s, c,
                  chunks, st);
  if (dtype == 1)
    return launch(static_cast<const __half*>(x), part, s1, s2, n, s, c, chunks,
                  st);
  if (dtype == 2)
    return launch(static_cast<const float*>(x), part, s1, s2, n, s, c, chunks,
                  st);
  return (int)cudaErrorInvalidValue;
}
