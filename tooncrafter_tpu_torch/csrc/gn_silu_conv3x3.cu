// GroupNorm-affine + SiLU + 3x3 SAME convolution for Hopper (sm_90a), with
// the bias / residual / statistics epilogue, bf16 in and out:
//
//   z     = silu(bf16(x * A + B))           (the "ref" cast point: the fp32
//                                            affine rounds to bf16, then an
//                                            fp32 SiLU rounds once more)
//   y     = conv3x3(z) + bias + residual     (fp32, rounded once to bf16)
//   stats = per-image, per-channel fp32 sums of y and y^2 (of the rounded y)
//
// The halo outside the image contributes 0: the zero of z, not silu(B).
//
// Replaces the TPU kernel tooncrafter_tpu/ops/winograd.py::
// winograd_gn_silu_conv3x3 (F(2x2,3x3) Winograd), its F(2x4) twin and, with
// the prologue at the fp32 cast point (round_first 0), the im2col kernel
// tooncrafter_tpu/ops/spatial_conv.py::_pallas_fused_conv. This is a direct
// implicit GEMM instead (implicit_gemm.cuh): M = the pixels of one image,
// N = Cout, K = 9 * Cin (tap-major, then input channel). The function is the
// same; the Winograd transform was the TPU's way to spend fewer MXU
// multiplies where its direct conv ran at 71-98% of peak, and it rounds its
// transformed tiles to bf16, which a direct product does not. The TPU
// dispatched it only on an allowlist of shapes that Mosaic could lower (cin
// % 128, not the 40x64 level); this kernel runs at every 3x3 conv of the
// UNet's ResBlocks.
//
// What bounds it on the H100: 2 * 9 * Cin operations per output element
// against ~4 bytes in and out per pixel and channel: at Cin >= 320 well
// above ~295 operations per byte, so the tensor cores bound it. What the
// fused form saves: the normalised, activated z never reaches device
// memory (the plain form writes and reads it, plus an fp32 copy for the
// norm), and the residual add and the next norm's statistics ride the
// epilogue. Each block activates each input element of its halo once per
// 32-channel chunk, and its nine taps read that halo shifted.

#include "implicit_gemm.cuh"

namespace {

using igemm::Params;

template <int BM, bool kRoundFirst>
int launch_bm(Params q, cudaStream_t stream) {
  q.n_mtiles = (q.h * q.wd + BM - 1) / BM;
  const int rows = BM + 2 * q.wd + 2;  // the halo
  const int smem = igemm::conv_smem_fixed<BM>() + 2 * q.cin * 4 +
                   2 * rows * igemm::kKP * 2;
  cudaError_t err = cudaFuncSetAttribute(
      igemm::conv_kernel<BM, kRoundFirst>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(q.n_mtiles, (q.cout + igemm::kConvBN - 1) / igemm::kConvBN,
                  q.frames);
  igemm::conv_kernel<BM, kRoundFirst>
      <<<grid, igemm::kThreads, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, cin), w (cout, 3, 3, cin), bias (cout), res/out (N, H, W,
// cout): contiguous bf16; a, b: fp32 (N, cin); s1, s2: fp32 (N, n_mtiles,
// cout) with n_mtiles = ceil(H * W / bm), or both null. bm is 64 or 128,
// cin % 32 == 0, cout % 8 == 0, W <= 256. Returns a cudaError_t code (0 on
// success).
extern "C" int tc_gn_silu_conv3x3(const void* x, const float* a, const float* b,
                                  const void* w, const void* bias,
                                  const void* res, void* out, float* s1,
                                  float* s2, int n, int h, int wd, int cin,
                                  int cout, int silu, int bm, int round_first,
                                  void* stream) {
  Params q;
  q.x = static_cast<const bf16*>(x);
  q.a = a;
  q.b = b;
  q.w = static_cast<const bf16*>(w);
  q.bias = static_cast<const bf16*>(bias);
  q.res = static_cast<const bf16*>(res);
  q.scale = nullptr;
  q.out = static_cast<bf16*>(out);
  q.s1 = s1;
  q.s2 = s2;
  q.frames = n;
  q.t = 1;
  q.h = h;
  q.wd = wd;
  q.cin = cin;
  q.cout = cout;
  q.silu = silu;
  if (a == nullptr || b == nullptr || igemm::bad_params(q) ||
      wd > igemm::kMaxWidth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return round_first ? launch_bm<128, true>(q, s) : launch_bm<128, false>(q, s);
  if (bm == 64)
    return round_first ? launch_bm<64, true>(q, s) : launch_bm<64, false>(q, s);
  return (int)cudaErrorInvalidValue;
}
