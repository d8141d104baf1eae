// GroupNorm (+SiLU) over each sample of a channels-last (N, HW, C) bf16
// tensor, for Hopper (sm_90a). Replaces the TPU kernel
// tooncrafter_tpu/ops/fused_norms.py::_pallas_gn, with its rounding:
//
//   s1[c] = sum over HW of x,   s2[c] = sum over HW of bf16(x * x)  (fp32)
//   per group g: mean = S1 / n, var = max(S2 / n - mean^2, 0), n = HW C / G
//   A[c] = rsqrt(var + eps) * scale[c],   B[c] = bias[c] - mean A[c]
//   y = x A + B in fp32, then y * sigmoid(y) in fp32 when silu, rounded once
//
// The TPU kernel holds one sample (<= 4 MiB) in VMEM and reads it once for
// the sums and once for the output. A block here has no room for a sample,
// and blocks cannot wait for each other, so the same function is three
// launches on the stream, made by one call:
//   1. partial sums: block (chunk, n) sums a chunk of rows of sample n into
//      (n, chunk, 2, C) fp32 (each thread one 8-channel column, 16-byte
//      loads; the threads of a column reduce through shared memory);
//   2. per sample: the partials summed over chunks in a fixed order, the
//      group statistics and the folded (A, B), (n, 2, C) fp32;
//   3. apply: block (chunk, n) writes y for its rows, 16-byte loads/stores.
// No atomics: a run is deterministic. What bounds it on the H100: x is read
// twice and y written once (6 bytes an element against ~10 operations), so
// the bytes do; the least time counts one read and one write.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kApplyThreads = 256;

__global__ void gn_partial(const bf16* __restrict__ x, float* __restrict__ part,
                           int hw, int c, int rows, int rstep) {
  extern __shared__ float sred[];  // [rstep][2][c]
  const int cv = c / 8;
  const int v = threadIdx.x % cv, ro = threadIdx.x / cv;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * rows, r1 = min(hw, r0 + rows);
  float s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
  const bf16* xs = x + (long long)n * hw * c + v * 8;
  for (int r = r0 + ro; r < r1; r += rstep) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(xs + (long long)r * c));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t wj = w[j];
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&wj));
      s1[2 * j] += f.x;
      s1[2 * j + 1] += f.y;
      s2[2 * j] += round_bf16(f.x * f.x);  // the square in bf16
      s2[2 * j + 1] += round_bf16(f.y * f.y);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sred[(ro * 2) * c + v * 8 + i] = s1[i];
    sred[(ro * 2 + 1) * c + v * 8 + i] = s2[i];
  }
  __syncthreads();
  const int chunks = gridDim.x;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rstep; ++k) {
      a += sred[(k * 2) * c + ch];
      b += sred[(k * 2 + 1) * c + ch];
    }
    float* dst = part + (((long long)n * chunks + chunk) * 2) * c;
    dst[ch] = a;
    dst[c + ch] = b;
  }
}

__global__ void gn_finalize(const float* __restrict__ part,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            float* __restrict__ ab, int hw, int c, int groups,
                            int chunks, float eps) {
  extern __shared__ float sc[];  // [2][c] per-channel sums
  const int n = blockIdx.x;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float* src = part + (((long long)n * chunks + k) * 2) * c;
      a += src[ch];
      b += src[c + ch];
    }
    sc[ch] = a;
    sc[c + ch] = b;
  }
  __syncthreads();
  const int cg = c / groups;
  const float cnt = (float)hw * (float)cg;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / cg) * cg;
    float a = 0.f, b = 0.f;
    for (int k = 0; k < cg; ++k) {
      a += sc[g0 + k];
      b += sc[c + g0 + k];
    }
    const float mean = a / cnt;
    const float var = fmaxf(b / cnt - mean * mean, 0.f);
    const float inv = 1.f / sqrtf(var + eps);
    const float A = inv * scale[ch];
    ab[(long long)n * 2 * c + ch] = A;
    ab[(long long)n * 2 * c + c + ch] = bias[ch] - mean * A;
  }
}

__global__ void __launch_bounds__(kApplyThreads)
    gn_apply(const bf16* __restrict__ x, const float* __restrict__ ab,
             bf16* __restrict__ out, int hw, int c, int rows, int silu) {
  extern __shared__ float sab[];  // [2][c]
  const int n = blockIdx.y, chunk = blockIdx.x;
  for (int ch = threadIdx.x; ch < 2 * c; ch += blockDim.x)
    sab[ch] = ab[(long long)n * 2 * c + ch];
  __syncthreads();
  const int cv = c / 8;
  const int r0 = chunk * rows, r1 = min(hw, r0 + rows);
  const long long base = ((long long)n * hw + r0) * c;
  const long long total = (long long)(r1 - r0) * cv;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int c0 = (int)(i % cv) * 8;
    const long long off = base + (i / cv) * c + c0;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + off));
    uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      float y0 = f.x * sab[c0 + 2 * j] + sab[c + c0 + 2 * j];
      float y1 = f.y * sab[c0 + 2 * j + 1] + sab[c + c0 + 2 * j + 1];
      if (silu) {
        y0 = y0 * (1.f / (1.f + expf(-y0)));
        y1 = y1 * (1.f / (1.f + expf(-y1)));
      }
      w[j] = pack_bf16(y0, y1);
    }
    *reinterpret_cast<uint4*>(out + off) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace

// x, out: contiguous bf16 (n, hw, c); scale, bias: fp32 (c); part: fp32
// scratch of n * chunks * 2 * c; ab: fp32 (n, 2, c), the folded affine
// (written). c % 8 == 0, c % groups == 0, c <= 4096; rows = ceil(hw / chunks)
// rows a chunk. Returns a cudaError_t code (0 on success).
extern "C" int tc_group_norm_silu(const void* x, const float* scale,
                                  const float* bias, void* out, float* part,
                                  float* ab, int n, int hw, int c, int groups,
                                  int chunks, float eps, int silu,
                                  void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || c % 8 || groups <= 0 || c % groups ||
      c > 4096 || chunks <= 0 || chunks > hw || n > 65535 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = (hw + chunks - 1) / chunks;
  if ((long long)rows * (chunks - 1) >= hw) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int cv = c / 8;
  const int rstep = cv >= 256 ? 1 : 256 / cv;
  const int smem1 = rstep * 2 * c * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gn_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  gn_partial<<<dim3(chunks, n), cv * rstep, smem1, s>>>(xb, part, hw, c, rows,
                                                        rstep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize<<<n, 256, 2 * c * sizeof(float), s>>>(part, scale, bias, ab, hw,
                                                     c, groups, chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply<<<dim3(chunks, n), kApplyThreads, 2 * c * sizeof(float), s>>>(
      xb, ab, static_cast<bf16*>(out), hw, c, rows, silu);
  return (int)cudaGetLastError();
}
