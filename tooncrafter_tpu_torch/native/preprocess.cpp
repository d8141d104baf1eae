// Native host-side preprocessing for the video data path.
//
// The reference leans on native third-party code for this work (decord's
// C++ decode + torchvision/ffmpeg encode); here the per-frame transform
// itself — bilinear resize-to-cover, center crop, [-1,1] normalize — is
// first-party C++, multithreaded across frames, exposed through a C ABI
// for ctypes. Layout: uint8 HWC in, float32 HWC out (channels-last,
// matching the TPU pipeline).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// bilinear sample of one output row from the source frame
inline void resize_row_bilinear(const uint8_t* src, int sh, int sw,
                                float* dst, int dw, float sy, float x_ratio,
                                float x_off) {
  const int y0 = std::max(0, std::min(sh - 1, static_cast<int>(std::floor(sy))));
  const int y1 = std::min(sh - 1, y0 + 1);
  const float fy = std::min(1.f, std::max(0.f, sy - static_cast<float>(y0)));
  const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
  const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
  for (int x = 0; x < dw; ++x) {
    const float sx = x * x_ratio + x_off;
    const int x0 = std::max(0, std::min(sw - 1, static_cast<int>(std::floor(sx))));
    const int x1 = std::min(sw - 1, x0 + 1);
    const float fx = std::min(1.f, std::max(0.f, sx - static_cast<float>(x0)));
    for (int c = 0; c < 3; ++c) {
      const float a = row0[x0 * 3 + c] * (1.f - fx) + row0[x1 * 3 + c] * fx;
      const float b = row1[x0 * 3 + c] * (1.f - fx) + row1[x1 * 3 + c] * fx;
      const float v = a * (1.f - fy) + b * fy;
      dst[x * 3 + c] = v * (1.f / 127.5f) - 1.f;
    }
  }
}

void process_frame(const uint8_t* src, int sh, int sw, float* dst, int th,
                   int tw) {
  // resize-to-cover then center crop: scale = max(th/sh, tw/sw)
  const float scale =
      std::max(static_cast<float>(th) / sh, static_cast<float>(tw) / sw);
  const float inv = 1.f / scale;
  // center-aligned sampling (half-pixel convention)
  const float y_off = ((sh - th * inv) * 0.5f) + 0.5f * inv - 0.5f;
  const float x_off = ((sw - tw * inv) * 0.5f) + 0.5f * inv - 0.5f;
  for (int y = 0; y < th; ++y) {
    const float sy = y * inv + y_off;
    resize_row_bilinear(src, sh, sw, dst + static_cast<size_t>(y) * tw * 3,
                        tw, sy, inv, x_off);
  }
}

}  // namespace

extern "C" {

// in:  (t, sh, sw, 3) uint8 RGB frames
// out: (t, th, tw, 3) float32 in [-1, 1]
// returns 0 on success
int preprocess_clip(const uint8_t* in, int t, int sh, int sw, float* out,
                    int th, int tw, int num_threads) {
  if (t <= 0 || sh <= 0 || sw <= 0 || th <= 0 || tw <= 0) return 1;
  const size_t in_stride = static_cast<size_t>(sh) * sw * 3;
  const size_t out_stride = static_cast<size_t>(th) * tw * 3;
  int workers = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min(workers, t));
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([=]() {
      for (int i = w; i < t; i += workers) {
        process_frame(in + i * in_stride, sh, sw, out + i * out_stride, th,
                      tw);
      }
    });
  }
  for (auto& th_ : pool) th_.join();
  return 0;
}

// float32 [-1,1] (t,h,w,3) -> uint8 (t,h,w,3), threaded
int to_uint8_clip(const float* in, int t, int h, int w, uint8_t* out,
                  int num_threads) {
  if (t <= 0) return 1;
  const size_t stride = static_cast<size_t>(h) * w * 3;
  int workers = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min(workers, t));
  std::vector<std::thread> pool;
  for (int wk = 0; wk < workers; ++wk) {
    pool.emplace_back([=]() {
      for (int i = wk; i < t; i += workers) {
        const float* src = in + i * stride;
        uint8_t* dst = out + i * stride;
        for (size_t j = 0; j < stride; ++j) {
          float v = (std::min(1.f, std::max(-1.f, src[j])) + 1.f) * 127.5f;
          dst[j] = static_cast<uint8_t>(v + 0.5f > 255.f ? 255.f : v + 0.5f);
        }
      }
    });
  }
  for (auto& th_ : pool) th_.join();
  return 0;
}

}  // extern "C"
