// Temporal (3,1,1) convolution for Hopper (sm_90a) with the fused GroupNorm
// prologue and the scale / residual / statistics epilogue, bf16 in and out:
//
//   z[s]  = silu(x[s] * A + B)              (fp32, rounded once to bf16)
//   y[t]  = (z[t-1] W0 + z[t] W1 + z[t+1] W2 + b) * scale + residual[t]
//   stats = per-frame, per-channel fp32 sums of y and y^2 (of the rounded y)
//
// z is zero-padded at t = -1 and t = T: the padding is of z, not of x (the
// prologue runs before the window, as _xla_tconv pads after it).
//
// Replaces the TPU kernel tooncrafter_tpu/ops/temporal_conv.py::
// _pallas_tconv. Its callers: the UNet's TemporalConvBlock (four convs
// chained through their stats, the last with the block residual) and the
// dual-ref decoder's TimeStack (the alpha merge x + sigmoid(mix) * stack(x)
// as scale + residual).
//
// Design: an implicit GEMM (implicit_gemm.cuh) with M = the pixels of one
// frame, N = Cout, K = 3 taps * Cin, one block per (pixel tile, Cout tile,
// frame). The TPU kernel held a (T, pixel tile, C) slab in VMEM and read x
// once; here every frame is its own block, which gives the card enough
// blocks at the UNet's deep levels (P = 160 and 40 pixels a frame, 32
// frames), and each block reads its three source frames (the neighbours'
// reads mostly hit L2).
//
// What bounds it on the H100: at the decoder's level 0 (C = 128) an output
// element costs 2 * 3 * C = 768 operations on 2 + 2 (+ 2 residual) bytes of
// x and y: ~130-190 operations per byte, below the card's ~295, so device
// memory bounds it there; at the UNet's C >= 320 the products bound it.
// What the fused form saves: the normalised z never reaches device memory,
// and the residual, scale and statistics ride the epilogue instead of three
// more passes.

#include "implicit_gemm.cuh"

namespace {

using igemm::Params;

template <int BM, int NT, int S>
int launch_bm(Params q, cudaStream_t stream) {
  q.n_mtiles = (q.h * q.wd + BM - 1) / BM;
  const int smem = igemm::tconv_smem_fixed<BM, NT, S>() + 2 * q.cin * 4;
  cudaError_t err = cudaFuncSetAttribute(
      igemm::tconv_kernel<BM, NT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(q.n_mtiles, (q.cout + 32 * NT - 1) / (32 * NT), q.frames);
  igemm::tconv_kernel<BM, NT, S><<<grid, igemm::kThreads, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, P, cin), w (cout, 3, cin): taps t-1, t, t+1, bias (cout),
// res/out (B, T, P, cout): contiguous bf16; a, b: fp32 (B, cin) or both
// null (no prologue, silu 0); scale: a device fp32 scalar or null; s1, s2:
// fp32 (B * T, n_mtiles, cout) with n_mtiles = ceil(P / bm), or both null.
// (bm, bn) is (64 or 128, 128) or (64, 320), cin % 32 == 0, cout % 8 == 0.
// Returns a cudaError_t code (0 on success).
extern "C" int tc_temporal_conv(const void* x, const void* w, const void* bias,
                                const float* a, const float* b, const void* res,
                                const float* scale, void* out, float* s1,
                                float* s2, int batch, int t, int p, int cin,
                                int cout, int silu, int bm, int bn,
                                void* stream) {
  Params q;
  q.x = static_cast<const bf16*>(x);
  q.a = a;
  q.b = b;
  q.w = static_cast<const bf16*>(w);
  q.bias = static_cast<const bf16*>(bias);
  q.res = static_cast<const bf16*>(res);
  q.scale = scale;
  q.out = static_cast<bf16*>(out);
  q.s1 = s1;
  q.s2 = s2;
  q.frames = batch * t;
  q.t = t;
  q.h = p;
  q.wd = 1;
  q.cin = cin;
  q.cout = cout;
  q.silu = silu;
  if (batch <= 0 || t <= 0 || (a == nullptr) != (b == nullptr) ||
      igemm::bad_params(q))
    return (int)cudaErrorInvalidValue;
  // the UNet's widths (bn 320, bm 64): each source element is activated
  // once per tap, not once per 128-wide Cout tile
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 320 && bm == 64) return launch_bm<64, 10, 3>(q, s);
  if (bn == 128 && bm == 128) return launch_bm<128, 4, 4>(q, s);
  if (bn == 128 && bm == 64) return launch_bm<64, 4, 4>(q, s);
  return (int)cudaErrorInvalidValue;
}
