// Native host-side kernels for the input pipeline (the JAX package's
// native/fnst_host.cpp, ABI version 1).
//
// The two hot non-decode stages of the host pipeline are bilinear resize
// and the uint8 -> ImageNet-normalized float32 conversion. Both are
// multithreaded C++ with auto-vectorizable inner loops, exposed through a
// plain C ABI and loaded with ctypes (native/__init__.py builds it).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfnst_host.so fnst_host.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Work-stealing-free static partition: rows are split evenly across threads.
template <typename F>
void parallel_rows(int64_t n_rows, int n_threads, F&& fn) {
  if (n_threads <= 1 || n_rows < 64) {
    fn(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// uint8 NHWC batch -> float32 NHWC, fused x/255, (x-mean)/std.
// src: (n, h, w, 3) uint8; dst: same shape float32.
// mean/stdinv: 3 floats each (stdinv = 1/std precomputed by the caller).
void fnst_normalize_u8_to_f32(const uint8_t* src, float* dst, int64_t n,
                              int64_t h, int64_t w, const float* mean,
                              const float* stdinv, int n_threads) {
  // Precompute the 256-entry LUT per channel: lut[c][v] = (v/255 - mean)/std.
  float lut[3][256];
  for (int c = 0; c < 3; ++c) {
    for (int v = 0; v < 256; ++v) {
      lut[c][v] = (static_cast<float>(v) * (1.0f / 255.0f) - mean[c]) * stdinv[c];
    }
  }
  int64_t rows = n * h;
  int64_t row_elems = w * 3;
  parallel_rows(rows, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* s = src + r * row_elems;
      float* d = dst + r * row_elems;
      int64_t i = 0;
      for (; i + 3 <= row_elems; i += 3) {
        d[i + 0] = lut[0][s[i + 0]];
        d[i + 1] = lut[1][s[i + 1]];
        d[i + 2] = lut[2][s[i + 2]];
      }
    }
  });
}

// Bilinear resize uint8 HWC (3 channels), matching PIL's half-pixel centers
// (align_corners=False convention used by torchvision Resize).
void fnst_resize_bilinear_u8(const uint8_t* src, int64_t sh, int64_t sw,
                             uint8_t* dst, int64_t dh, int64_t dw,
                             int n_threads) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  // Precompute x coordinates/weights once.
  std::vector<int32_t> x0(dw), x1(dw);
  std::vector<float> wx(dw);
  for (int64_t x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * scale_x - 0.5f;
    if (fx < 0) fx = 0;
    int32_t ix = static_cast<int32_t>(fx);
    if (ix > sw - 1) ix = sw - 1;
    x0[x] = ix;
    x1[x] = ix + 1 < sw ? ix + 1 : sw - 1;
    wx[x] = fx - ix;
  }
  parallel_rows(dh, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      float fy = (y + 0.5f) * scale_y - 0.5f;
      if (fy < 0) fy = 0;
      int64_t y0 = static_cast<int64_t>(fy);
      if (y0 > sh - 1) y0 = sh - 1;
      int64_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
      float wy = fy - y0;
      const uint8_t* r0 = src + y0 * sw * 3;
      const uint8_t* r1 = src + y1 * sw * 3;
      uint8_t* out = dst + y * dw * 3;
      for (int64_t x = 0; x < dw; ++x) {
        const uint8_t* p00 = r0 + x0[x] * 3;
        const uint8_t* p01 = r0 + x1[x] * 3;
        const uint8_t* p10 = r1 + x0[x] * 3;
        const uint8_t* p11 = r1 + x1[x] * 3;
        float w00 = (1 - wy) * (1 - wx[x]);
        float w01 = (1 - wy) * wx[x];
        float w10 = wy * (1 - wx[x]);
        float w11 = wy * wx[x];
        for (int c = 0; c < 3; ++c) {
          float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
          out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
        }
      }
    }
  });
}

int fnst_abi_version() { return 1; }

}  // extern "C"
