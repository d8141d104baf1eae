// Per-channel sums over the rows of a channels-last (N, S, C) tensor: what
// the one-pass GroupNorm (+SiLU) (group_norm_silu.cu, #16) and the channel
// sums (channel_sums.cu, #18) share.
//
// The loader. A block's rows of one sample are one contiguous byte range.
// `stream` copies it into shared memory by 1-D bulk copies (cp.async.bulk,
// no tensor map), issued by one thread, in stages (of ~16 KB: the plans,
// ops/row_sums.py), each completing on its own mbarrier, `slots` stages in
// flight (tens of KB an SM where one 16-byte load a thread kept a few KB
// in flight). With as many slots as stages nothing is reloaded and the
// range stays resident.
//
// The column sums. The threads of a block are (column, row offset) pairs:
// thread t = ro * cv + v owns the 16-byte column v (cv = C * itemsize / 16)
// and the rows ro, ro + rstep, ... of the range (T = cv * rstep threads).
// A stage is a whole number of rstep-row groups, so thread t reads vectors
// t, t + T, ... of every stage and its column never changes. It sums x and
// x^2 in fp32 registers, row by row in order; `fold_columns` then adds the
// row offsets' sums per channel in the order 0 .. rstep - 1.
//
// Every sum is taken in an order fixed by the plan, with no float atomics,
// so two calls agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace rowsums {

constexpr int kMaxSlots = 32;         // the mbarriers a block keeps
constexpr int kBarBytes = kMaxSlots * 8;

// 16 bytes of x as floats: 8 bf16 / fp16 values or 4 fp32 values
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t wj = w[j];
      const float2 p =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&wj));
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

// The squares of two values in the sums of x^2. #16 rounds them to bf16
// (the TPU kernel squares x in x's dtype; one packed conversion for the
// two); #18 keeps them in fp32. __fmul_rn: each product is rounded to fp32
// on its own, never contracted into the sum's add.
struct SquareBf16 {
  __device__ static float2 sq2(float a, float b) {
    return __bfloat1622float2(
        __floats2bfloat162_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
  }
};
struct SquareF32 {
  __device__ static float2 sq2(float a, float b) {
    return make_float2(__fmul_rn(a, a), __fmul_rn(b, b));
  }
};

// ---------------------------------------------------------------------------
// the loader
// ---------------------------------------------------------------------------

struct Ring {
  uint64_t* bar;    // kMaxSlots mbarriers
  char* buf;        // the slots, one after another
  uint32_t parity;  // bit j: the parity of slot j's next completion
};

// every thread of the block; ends with a barrier
__device__ inline Ring ring_init(uint64_t* bar, char* buf) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < kMaxSlots; ++j) sm90::mbar_init(&bar[j], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  return Ring{bar, buf, 0u};
}

// `bytes` of global memory at `src` (16-byte aligned, a multiple of 16)
// through `slots` slots in stages of `stage` bytes (a multiple of 16; the
// last may be shorter), in order: every thread of the block calls
// f(the stage in shared memory, its index, its bytes). Stage s lands in
// slot s % slots; a slot is refilled once every thread is done with it.
template <typename F>
__device__ void stream(Ring& r, const char* src, long long bytes, int stage,
                       int slots, F&& f) {
  const int stages = (int)((bytes + stage - 1) / stage);
  auto size = [&](int s) {
    return (int)min((long long)stage, bytes - (long long)s * stage);
  };
  auto issue = [&](int s) {
    const int slot = s % slots;
    sm90::mbar_expect_tx(&r.bar[slot], (uint32_t)size(s));
    sm90::bulk_load(r.buf + (long long)slot * stage,
                    src + (long long)s * stage, (uint32_t)size(s),
                    &r.bar[slot]);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < stages && s < slots; ++s) issue(s);
  for (int s = 0; s < stages; ++s) {
    const int slot = s % slots;
    sm90::mbar_wait(&r.bar[slot], (r.parity >> slot) & 1u);
    r.parity ^= 1u << slot;
    f(r.buf + (long long)slot * stage, s, size(s));
    if (s + slots < stages) {
      __syncthreads();  // every thread is done with the slot
      if (threadIdx.x == 0) issue(s + slots);
    }
  }
}

// ---------------------------------------------------------------------------
// the column sums
// ---------------------------------------------------------------------------

// thread t's sums of x and x^2 over its rows of one stage: its vectors t,
// t + T, ... in order
template <typename T, typename Square, int V = Vec<T>::n>
__device__ __forceinline__ void add_rows(const char* stage, int bytes,
                                         float (&s1)[V], float (&s2)[V]) {
  const uint4* p = reinterpret_cast<const uint4*>(stage);
#pragma unroll 4
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    float f[V];
    Vec<T>::load(p[i], f);
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float2 q = Square::sq2(f[j], f[j + 1]);
      s1[j] += f[j];
      s1[j + 1] += f[j + 1];
      s2[j] += q.x;
      s2[j + 1] += q.y;
    }
  }
}

// per channel, the row offsets' sums in the order 0 .. rstep - 1, into
// out[0 .. c) (shared or global memory), through `red` (rstep * c floats
// of shared memory). Every thread of the block; ends with a barrier.
template <int V>
__device__ void fold_columns(const float (&acc)[V], float* red, int c,
                             int rstep, float* out) {
  const int cv = c / V;
  const int v = threadIdx.x % cv, ro = threadIdx.x / cv;
#pragma unroll
  for (int j = 0; j < V; ++j) red[ro * c + v * V + j] = acc[j];
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f;
    for (int k = 0; k < rstep; ++k) a += red[k * c + ch];
    out[ch] = a;
  }
  __syncthreads();
}

}  // namespace rowsums
