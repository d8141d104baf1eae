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
// operations a byte at T = 16, far below the card's ~295, so the bytes do.
// A first version: one warp per (b, p, h) problem, grid-stride; the warp
// copies the problem's q, k and v rows into shared memory with 16-byte
// loads (a shared row of D / 2 + 1 words: an odd stride, so the lanes' own
// q rows fall in distinct banks), lane i < T computes query row i on the
// CUDA cores (its T logits in registers), writes its o row over its q row
// in shared memory, and the warp stores the o rows with 16-byte stores.
// Lanes T..31 idle at T = 16; tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxT = 32;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;                   // (b, t, p, heads * d), contiguous
  long long sq[3], sk[3], sv[3];  // element strides of b, t and p
  int b, t, p, heads;
  float scale;
};

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) ptc_kernel(const Params p) {
  constexpr int RS = D / 2 + 1;  // shared row, in 32-bit words
  constexpr int PR = D / 8;      // 16-byte pieces a row
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* sq = smem + warp * 3 * p.t * RS;
  uint32_t* sk = sq + p.t * RS;
  uint32_t* sv = sk + p.t * RS;
  const int inner = p.heads * D;
  const long long problems = (long long)p.b * p.p * p.heads;
  for (long long pr = (long long)blockIdx.x * kWarps + warp; pr < problems;
       pr += (long long)gridDim.x * kWarps) {
    const int h = (int)(pr % p.heads);
    const long long bp = pr / p.heads;
    const long long px = bp % p.p, bi = bp / p.p;
    for (int j = lane; j < p.t * PR; j += 32) {
      const int r = j / PR, c = (j % PR) * 8;
      const bf16* src[3] = {
          p.q + bi * p.sq[0] + r * p.sq[1] + px * p.sq[2] + h * D + c,
          p.k + bi * p.sk[0] + r * p.sk[1] + px * p.sk[2] + h * D + c,
          p.v + bi * p.sv[0] + r * p.sv[1] + px * p.sv[2] + h * D + c};
      uint32_t* dst[3] = {sq, sk, sv};
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src[m]));
        uint32_t* row = dst[m] + r * RS + c / 2;
        row[0] = u.x;
        row[1] = u.y;
        row[2] = u.z;
        row[3] = u.w;
      }
    }
    __syncwarp();
    if (lane < p.t) {
      float l[kMaxT];
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) l[j] = 0.f;
      const uint32_t* qr = sq + lane * RS;
      for (int c = 0; c < D / 2; ++c) {
        const float2 qa = unpack(qr[c]);
#pragma unroll
        for (int j = 0; j < kMaxT; ++j)
          if (j < p.t) {
            const float2 kb = unpack(sk[j * RS + c]);
            l[j] += qa.x * kb.x + qa.y * kb.y;
          }
      }
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < p.t) {
          l[j] *= p.scale;
          m = fmaxf(m, l[j]);
        }
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < p.t) {
          l[j] = expf(l[j] - m);
          den += l[j];
        }
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < p.t) l[j] = round_bf16(l[j] / den);
      // o row lane = probs . v, eight columns at a time, over the q row
      uint32_t* orow = sq + lane * RS;
      for (int c = 0; c < D / 2; c += 4) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kMaxT; ++j)
          if (j < p.t) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 vb = unpack(sv[j * RS + c + e]);
              acc[2 * e] += l[j] * vb.x;
              acc[2 * e + 1] += l[j] * vb.y;
            }
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[c + e] = pack_bf16(acc[2 * e], acc[2 * e + 1]);
      }
    }
    __syncwarp();
    for (int j = lane; j < p.t * PR; j += 32) {
      const int r = j / PR, c = (j % PR) * 8;
      const uint32_t* row = sq + r * RS + c / 2;
      *reinterpret_cast<uint4*>(
          p.out + ((bi * p.t + r) * p.p + px) * inner + h * D + c) =
          make_uint4(row[0], row[1], row[2], row[3]);
    }
    __syncwarp();  // the rows are free for the next problem
  }
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = kWarps * 3 * p.t * (D / 2 + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ptc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long problems = (long long)p.b * p.p * p.heads;
  const long long want = (problems + kWarps - 1) / kWarps;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  ptc_kernel<D><<<blocks, kWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (b, t, p, heads * d) at element strides s*[0..2] of b, t and
// p (the last axis contiguous, every stride a multiple of 8, the pointers
// 16-byte aligned); out: contiguous bf16 (b, t, p, heads * d). t <= 32, d 64
// or 128. Returns a cudaError_t code (0 on success).
extern "C" int tc_temporal_ptc(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int b,
                               int t, int p, int heads, int d, float scale,
                               void* stream) {
  if (b <= 0 || t <= 0 || t > kMaxT || p <= 0 || heads <= 0 ||
      (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  Params q_;
  q_.q = static_cast<const bf16*>(q);
  q_.k = static_cast<const bf16*>(k);
  q_.v = static_cast<const bf16*>(v);
  q_.out = static_cast<bf16*>(out);
  for (int i = 0; i < 3; ++i) {
    q_.sq[i] = strides[i];
    q_.sk[i] = strides[3 + i];
    q_.sv[i] = strides[6 + i];
  }
  q_.b = b;
  q_.t = t;
  q_.p = p;
  q_.heads = heads;
  q_.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(q_, s) : launch<128>(q_, s);
}
