// Implicit-GEMM kernels of the two fused convolutions, gn_silu_conv3x3.cu (a
// 3x3 SAME conv over each image) and temporal_conv.cu (a (3,1,1) conv over
// the frames of each sample): bf16 in and out, fp32 accumulation.
//
//   M = the pixels of one image / frame, N = Cout, K = taps x Cin
//   (the weight is (Cout, taps, Cin)).
//
// A source outside the image or the clip reads zeros of z, the activated
// input, not the prologue of a zero x.
//
// Prologue, applied to an input chunk in shared memory before the products
// read it (the folded GroupNorm affine A, B of the sample, fp32):
//   3x3 conv:       z = silu(bf16(x * A + B)), rounded to bf16 (the "ref"
//                   cast point of tooncrafter_tpu/ops/spatial_conv.py), or
//                   at the fp32 one, as the temporal conv
//                   (_pallas_fused_conv's prologue)
//   temporal conv:  z = silu(x * A + B) in fp32, rounded once to bf16
//                   (tooncrafter_tpu/ops/temporal_conv.py:107-110)
// Epilogue: y = (acc + bias) * scale + residual, rounded once to bf16; the
// per-channel fp32 sums of the rounded y over the tile's pixels go to a
// (frames, n_mtiles, Cout) buffer that the caller sums over the tiles: a
// fixed order and no atomics, so a run is deterministic.
//
// Both kernels: blocks of 256 threads over (pixel tile of BM = 64 or 128
// rows, 128 output channels, image / frame); 8 warps as 2 (M) x 4 (N), each
// a BM/2 x 32 fp32 tile in registers; mma.sync m16n8k16 with fragments by
// ldmatrix from shared rows padded to 80 bytes (the eight rows of a
// fragment fall in distinct banks). K runs in 32-channel steps through a
// ring of S shared-memory stages filled by cp.async S - 1 steps ahead, so
// the loads' latency hides behind the products; one barrier per step.
//
// The prologue costs more than the products it feeds (a SiLU is ~10
// instructions a thread, an m16n8k16 product one per warp), so each input
// element is activated as few times as the tiling allows:
//   * the 3x3 conv stages each 32-channel input chunk once, as a halo of
//     BM + 2W + 2 source pixels around the tile (copied raw with cp.async
//     while the previous chunk's nine taps run, then activated in place),
//     and each tap reads it shifted by dy * W + dx, zeroing the fragment
//     rows whose tap falls off the image's left or right edge (in the
//     linear pixel order those sources are pixels of the next row);
//   * the temporal conv activates each stage's chunk of one source frame
//     in place when it lands (three taps, so three times per element);
//   * the SiLU uses the fast exponential and reciprocal (their error is a
//     few fp32 ulps, far below the bf16 rounding that follows).
// wgmma, TMA and a persistent schedule are left for later work.

#pragma once

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace igemm {

constexpr int kThreads = 256;
constexpr int kBK = 32;         // input channels per step
constexpr int kKP = kBK + 8;    // padded shared row: 80 bytes
constexpr int kMaxWidth = 256;  // the conv's halo staging: image width cap

struct Params {
  const bf16* x;       // conv: (N, H, W, cin); temporal: (B, T, P, cin)
  const float* a;      // (samples, cin) folded affine, or null (no prologue)
  const float* b;
  const bf16* w;       // (cout, taps, cin)
  const bf16* bias;    // (cout)
  const bf16* res;     // like out, or null
  const float* scale;  // device scalar, or null
  bf16* out;           // (frames, h * wd, cout)
  float* s1;           // (frames, n_mtiles, cout), or null: no sums
  float* s2;
  int frames;          // images, or B * T
  int t;               // frames per sample (temporal); 1 for the conv
  int h, wd;           // image size; temporal: P and 1
  int cin, cout, silu, n_mtiles;
};

// 16 bytes global -> shared; with ok false the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool ok = true) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float fast_silu(float v) {
  return v * __frcp_rn(1.f + __expf(-v));
}

// z for eight channels in place: the affine (fp32), for the conv rounded to
// bf16 first, the SiLU, one rounding to bf16.
template <bool kRoundFirst>
__device__ __forceinline__ void prologue8(bf16* p, const float* as,
                                          const float* bs, int silu) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[j]));
    float z0 = x.x * as[2 * j] + bs[2 * j];
    float z1 = x.y * as[2 * j + 1] + bs[2 * j + 1];
    if (kRoundFirst) {
      z0 = round_bf16(z0);
      z1 = round_bf16(z1);
    }
    if (silu) {
      z0 = fast_silu(z0);
      z1 = fast_silu(z1);
    }
    u[j] = pack_bf16(z0, z1);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// this thread's 16-byte pieces of one tap's (32 NT x 32) weight chunk
template <int NT>
__device__ __forceinline__ void copy_b(bf16* sB, const Params& p, int taps,
                                       int n0, int tap, int k0, int ar, int ac) {
#pragma unroll
  for (int i = 0; i < 32 * NT / 64; ++i) {
    const int n = n0 + ar + 64 * i;
    const bool ok = n < p.cout;
    cp_async16(sB + (ar + 64 * i) * kKP + ac,
               p.w + ((long long)(ok ? n : 0) * taps + tap) * p.cin + k0 + ac, ok);
  }
}

// acc += A (rows a_row0 + 0 .. of sA) * B (sB) over one 32-deep step;
// ``keep`` zeroes this thread's fragment rows that must not read. A warp
// covers NT n8 tiles; B fragments are loaded a pair of tiles at a time.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const bf16* sA, const bf16* sB,
                                         int a_row0, int wn, int lane,
                                         const uint32_t (&keep)[MT][2]) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldmatrix_x4(af[mt], sA + (a_row0 + mt * 16 + (lane & 15)) * kKP + kk +
                              (lane >> 4) * 8);
      af[mt][0] &= keep[mt][0];
      af[mt][2] &= keep[mt][0];
      af[mt][1] &= keep[mt][1];
      af[mt][3] &= keep[mt][1];
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, sB + (wn * 8 * NT + j * 16 + ((lane >> 4) << 3) +
                             (lane & 7)) * kKP +
                           kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][2 * j], af[mt], bfr[0], bfr[1]);
        mma_16816(acc[mt][2 * j + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// (acc + bias) * scale + residual, one rounding, the sums of the rounded y
template <int BM, int NT>
__device__ __forceinline__ void epilogue(const Params& p,
                                         float (&acc)[BM / 32][NT][4],
                                         float* sStat, int m0, int n0, int f) {
  constexpr int MT = BM / 32;
  constexpr int BN = 32 * NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int hw = p.h * p.wd;
  const float scale = p.scale ? *p.scale : 1.f;
  float st1[NT][2], st2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    st1[nt][0] = st1[nt][1] = st2[nt][0] = st2[nt][1] = 0.f;
    const int col = n0 + wn * 8 * NT + nt * 8 + 2 * t4;
    if (col >= p.cout) continue;
    const float c0 = __bfloat162float(p.bias[col]);
    const float c1 = __bfloat162float(p.bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pix = m0 + wm * (BM / 2) + mt * 16 + g + 8 * r;
        if (pix >= hw) continue;
        const long long o = ((long long)f * hw + pix) * p.cout + col;
        float y0 = (acc[mt][nt][2 * r] + c0) * scale;
        float y1 = (acc[mt][nt][2 * r + 1] + c1) * scale;
        if (p.res) {
          const float2 rv = ld_bf162(p.res + o);
          y0 += rv.x;
          y1 += rv.y;
        }
        const uint32_t packed = pack_bf16(y0, y1);
        *reinterpret_cast<uint32_t*>(p.out + o) = packed;
        const float2 yr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&packed));
        st1[nt][0] += yr.x;
        st1[nt][1] += yr.y;
        st2[nt][0] += yr.x * yr.x;
        st2[nt][1] += yr.y * yr.y;
      }
  }
  if (p.s1 == nullptr) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        st1[nt][e] += __shfl_xor_sync(0xffffffffu, st1[nt][e], o);
        st2[nt][e] += __shfl_xor_sync(0xffffffffu, st2[nt][e], o);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn * 8 * NT + nt * 8 + 2 * t4 + e;
        sStat[(0 * 2 + wm) * BN + c] = st1[nt][e];
        sStat[(1 * 2 + wm) * BN + c] = st2[nt][e];
      }
  }
  __syncthreads();
  for (int c = tid; c < BN && n0 + c < p.cout; c += kThreads) {
    const long long o =
        ((long long)f * p.n_mtiles + blockIdx.x) * p.cout + n0 + c;
    p.s1[o] = sStat[0 * BN + c] + sStat[1 * BN + c];
    p.s2[o] = sStat[2 * BN + c] + sStat[3 * BN + c];
  }
}

__device__ __forceinline__ void stage_affine(float* sAff, const Params& p,
                                             int sample) {
  if (p.a == nullptr) return;
  for (int c = threadIdx.x; c < p.cin; c += kThreads) {
    sAff[c] = p.a[(long long)sample * p.cin + c];
    sAff[p.cin + c] = p.b[(long long)sample * p.cin + c];
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
}

// ---------------------------------------------------------------------------
// the temporal (3,1,1) conv: per step, the tile's pixels of one source frame
// ---------------------------------------------------------------------------

template <int BM, int NT, int S>
constexpr int tconv_smem_fixed() {
  return S * (BM + 32 * NT) * kKP * 2 + 2 * 2 * 32 * NT * 4;
}

// BM pixels x BN = 32 NT output channels a block, an S-stage ring
template <int BM, int NT, int S>
__global__ void __launch_bounds__(kThreads, 2) tconv_kernel(const Params p) {
  constexpr int RPT = BM / 64;   // A rows a thread copies
  constexpr int MT = BM / 32;
  constexpr int BN = 32 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);                   // [S][BM][kKP]
  bf16* sB = sA + S * BM * kKP;                               // [S][BN][kKP]
  float* sStat = reinterpret_cast<float*>(sB + S * BN * kKP);
  float* sAff = sStat + 2 * 2 * BN;                           // [2][cin]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int hw = p.h * p.wd;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, f = blockIdx.z;
  const int tf = f % p.t;
  stage_affine(sAff, p, f / p.t);

  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const bf16* xf = p.x + (long long)f * hw * p.cin;
  const int chunks = p.cin / kBK;
  const int steps = 3 * chunks;
  auto valid = [&](int i, int tap) {
    const int dt = tap - 1;
    return m0 + ar + 64 * i < hw && tf + dt >= 0 && tf + dt < p.t;
  };
  auto issue = [&](int s) {  // the raw x and the weight chunk of step s
    if (s < steps) {
      const int tap = s / chunks, k0 = (s - tap * chunks) * kBK;
      bf16* a = sA + (s % S) * BM * kKP;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const bool ok = valid(i, tap);
        const long long src = ok ? (long long)(tap - 1) * hw + m0 + ar + 64 * i : 0;
        cp_async16(a + (ar + 64 * i) * kKP + ac, xf + src * p.cin + k0 + ac, ok);
      }
      copy_b<NT>(sB + (s % S) * BN * kKP, p, 3, n0, tap, k0, ar, ac);
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
  uint32_t keep[MT][2];
  zero_acc(acc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) keep[mt][0] = keep[mt][1] = 0xffffffffu;

  for (int s = 0; s < S - 1; ++s) issue(s);
  __syncthreads();  // the affine is staged
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();  // this thread's copies of step s landed
    if (p.a != nullptr) {          // activate them in place
      const int tap = s / chunks, k0 = (s - tap * chunks) * kBK;
      bf16* a = sA + (s % S) * BM * kKP;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (valid(i, tap))
          prologue8<false>(a + (ar + 64 * i) * kKP + ac, sAff + k0 + ac,
                           sAff + p.cin + k0 + ac, p.silu);
    }
    __syncthreads();  // step s is in place for all; step s - 1 is consumed
    issue(s + S - 1);
    mma_step<MT, NT>(acc, sA + (s % S) * BM * kKP, sB + (s % S) * BN * kKP,
                     wm * (BM / 2), wn, lane, keep);
  }
  epilogue<BM, NT>(p, acc, sStat, m0, n0, f);
}

// ---------------------------------------------------------------------------
// the 3x3 conv: per input chunk, a halo of source pixels activated once
// ---------------------------------------------------------------------------

constexpr int kConvStages = 4;
constexpr int kConvBN = 128;

template <int BM>
constexpr int conv_smem_fixed() {
  return kConvStages * kConvBN * kKP * 2 + 2 * 2 * kConvBN * 4;
}

// kRoundFirst: the "ref" cast point (the affine rounds to bf16 before the
// SiLU); false: the fp32 one (tooncrafter_tpu/ops/spatial_conv.py::
// _pallas_fused_conv rounds once, after the SiLU)
template <int BM, bool kRoundFirst = true>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(const Params p) {
  constexpr int MT = BM / 32;
  constexpr int S = kConvStages, BN = kConvBN;
  const int W = p.wd;
  const int hw = p.h * W;
  const int R = BM + 2 * W + 2;  // halo rows: source pixels m0-W-1 .. m0+BM+W
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);                   // [S][BN][kKP]
  float* sStat = reinterpret_cast<float*>(sB + S * BN * kKP);
  float* sAff = sStat + 2 * 2 * BN;                           // [2][cin]
  bf16* sH = reinterpret_cast<bf16*>(sAff + 2 * p.cin);       // [R][kKP] z
  bf16* sRaw = sH + R * kKP;                                  // [R][kKP] x

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, f = blockIdx.z;
  const int base = m0 - W - 1;   // the source pixel of halo row 0
  stage_affine(sAff, p, f);

  // the edges of this thread's fragment rows: top, bottom, left, right
  uint32_t edge = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pix = m0 + wm * (BM / 2) + mt * 16 + g + 8 * r;
      const int y = pix / W, x = pix - y * W;
      const uint32_t bits = (y == 0) | ((y == p.h - 1) << 1) | ((x == 0) << 2) |
                            ((x == W - 1) << 3);
      edge |= bits << (4 * (2 * mt + r));
    }

  const bf16* xf = p.x + (long long)f * hw * p.cin;
  auto copy_raw = [&](int k0) {  // the chunk's halo, raw, by cp.async
    for (int j = tid; j < R * 4; j += kThreads) {
      const int row = j >> 2, s = base + row;
      if (s >= 0 && s < hw)
        cp_async16(sRaw + row * kKP + (j & 3) * 8,
                   xf + (long long)s * p.cin + k0 + (j & 3) * 8);
    }
  };
  auto activate = [&](int k0) {  // sRaw -> sH through the prologue
    for (int j = tid; j < R * 4; j += kThreads) {
      const int row = j >> 2, s = base + row, c = (j & 3) * 8;
      uint4* dst = reinterpret_cast<uint4*>(sH + row * kKP + c);
      if (s >= 0 && s < hw) {
        *dst = *reinterpret_cast<const uint4*>(sRaw + row * kKP + c);
        prologue8<kRoundFirst>(sH + row * kKP + c, sAff + k0 + c,
                        sAff + p.cin + k0 + c, p.silu);
      } else {
        *dst = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const int chunks = p.cin / kBK;
  const int steps = 9 * chunks;
  auto issue = [&](int s) {  // the weight chunk of step s (chunk, tap)
    if (s < steps) {
      const int c = s / 9, tap = s - c * 9;
      copy_b<4>(sB + (s % S) * BN * kKP, p, 9, n0, tap, c * kBK, ar, ac);
    }
    cp_async_commit();
  };

  float acc[MT][4][4];
  zero_acc(acc);
  copy_raw(0);
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int s = 0, c = 0, tap = 0; s < steps; ++s) {
    if (tap == 0) {
      cp_async_wait<0>();  // this thread's halo copies of chunk c landed
      __syncthreads();     // the previous chunk's taps are done with sH
      activate(c * kBK);
    } else {
      cp_async_wait<S - 2>();  // this thread's copies of step s
    }
    __syncthreads();  // step s is in place for all; step s - 1 is consumed
    if (tap == 0 && c + 1 < chunks) copy_raw((c + 1) * kBK);
    issue(s + S - 1);
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    uint32_t keep[MT][2];  // rows whose source lies off the image's edge
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t e = edge >> (4 * (2 * mt + r));
        const bool off = (dy < 0 && (e & 1)) || (dy > 0 && (e & 2)) ||
                         (dx < 0 && (e & 4)) || (dx > 0 && (e & 8));
        keep[mt][r] = off ? 0u : 0xffffffffu;
      }
    mma_step<MT, 4>(acc, sH, sB + (s % S) * BN * kKP,
                    wm * (BM / 2) + W + 1 + dy * W + dx, wn, lane, keep);
    if (++tap == 9) {
      tap = 0;
      ++c;
    }
  }
  epilogue<BM, 4>(p, acc, sStat, m0, n0, f);
}

// the checks both launchers make (temporal_conv.cu, gn_silu_conv3x3.cu)
inline bool bad_params(const Params& q) {
  return q.frames <= 0 || q.frames > 65535 || q.h <= 0 || q.wd <= 0 ||
         q.cin <= 0 || q.cin % kBK || q.cin > 8192 || q.cout <= 0 ||
         q.cout % 8 || (q.silu && q.a == nullptr);
}

}  // namespace igemm
