// Native host-side data pipeline of mvsnerf_tpu_torch (a copy of the JAX
// package's mvsnerf_tpu/native/src/mvsnerf_native.cc).
//
// The device path is PyTorch and CUDA; this library covers the host-side
// loops that feed it, the role torch's C++ DataLoader workers, cv2 and PIL
// play for the reference: PFM depth decoding, the DTU depth pyramid (x0.5
// nearest resize + crop + rescale), ImageNet normalisation and
// multi-threaded ray-batch gathering from flat ray buffers.
//
// Built as a plain shared library with g++ at first use and bound from
// Python via ctypes (mvsnerf_tpu_torch/native/__init__.py). All functions
// return 0 on success.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PFM -----

// Parse a PFM file already read into memory (bytes, len) into out (h*w*c
// float32, top-down row order). Returns channel count, or -1 on error.
// PFM stores rows bottom-up; scale < 0 means little-endian.
int pfm_decode(const uint8_t* bytes, int64_t len, float* out,
               int64_t* out_h, int64_t* out_w) {
  if (len < 8) return -1;
  const char* p = reinterpret_cast<const char*>(bytes);
  const char* end = p + len;

  auto read_line = [&](std::string* line) -> bool {
    line->clear();
    while (p < end && *p != '\n') line->push_back(*p++);
    if (p < end) ++p;  // consume newline
    return !line->empty();
  };

  std::string header, dims, scale_s;
  if (!read_line(&header)) return -1;
  int channels;
  if (header == "PF") channels = 3;
  else if (header == "Pf") channels = 1;
  else return -1;
  if (!read_line(&dims) || !read_line(&scale_s)) return -1;
  int64_t w, h;
  if (sscanf(dims.c_str(), "%ld %ld", &w, &h) != 2) return -1;
  double scale = atof(scale_s.c_str());
  bool little_endian = scale < 0;

  int64_t n = w * h * channels;
  if (end - p < static_cast<int64_t>(n * sizeof(float))) return -1;
  const float* data = reinterpret_cast<const float*>(p);

  // flip vertically (PFM is bottom-up)
  for (int64_t row = 0; row < h; ++row) {
    const float* src = data + (h - 1 - row) * w * channels;
    float* dst = out + row * w * channels;
    std::memcpy(dst, src, w * channels * sizeof(float));
  }
  if (!little_endian) {
    // byte-swap big-endian payloads in place
    uint32_t* u = reinterpret_cast<uint32_t*>(out);
    for (int64_t i = 0; i < n; ++i)
      u[i] = __builtin_bswap32(u[i]);
  }
  *out_h = h;
  *out_w = w;
  return channels;
}

// ------------------------------------------------------- nearest resize ---

// Nearest-neighbour resize matching cv2 INTER_NEAREST:
// src_index = floor(dst_index * (src_size / dst_size)).
int resize_nearest_f32(const float* src, int64_t sh, int64_t sw,
                       float* dst, int64_t dh, int64_t dw) {
  std::vector<int64_t> xs(dw);
  const double fx = static_cast<double>(sw) / dw;
  const double fy = static_cast<double>(sh) / dh;
  for (int64_t x = 0; x < dw; ++x) {
    int64_t sx = static_cast<int64_t>(x * fx);
    xs[x] = sx < sw ? sx : sw - 1;
  }
  for (int64_t y = 0; y < dh; ++y) {
    int64_t sy = static_cast<int64_t>(y * fy);
    if (sy >= sh) sy = sh - 1;
    const float* srow = src + sy * sw;
    float* drow = dst + y * dw;
    for (int64_t x = 0; x < dw; ++x) drow[x] = srow[xs[x]];
  }
  return 0;
}

// DTU depth pyramid (reference data/dtu.py:116-127): x0.5 nearest ->
// crop [44:556, 80:720] -> optional downSample nearest -> scale values.
// src is (sh, sw); out_h/out_w must match round(512*down), round(640*down).
int dtu_depth_pipeline(const float* src, int64_t sh, int64_t sw,
                       double down, double value_scale,
                       float* out, int64_t out_h, int64_t out_w) {
  int64_t h2 = static_cast<int64_t>(sh * 0.5 + 0.5);
  int64_t w2 = static_cast<int64_t>(sw * 0.5 + 0.5);
  std::vector<float> half(h2 * w2);
  resize_nearest_f32(src, sh, sw, half.data(), h2, w2);
  if (h2 < 556 || w2 < 720) return -1;
  // crop [44:556, 80:720] -> 512 x 640
  const int64_t ch = 512, cw = 640;
  std::vector<float> crop(ch * cw);
  for (int64_t y = 0; y < ch; ++y)
    std::memcpy(crop.data() + y * cw, half.data() + (y + 44) * w2 + 80,
                cw * sizeof(float));
  if (down != 1.0) {
    resize_nearest_f32(crop.data(), ch, cw, out, out_h, out_w);
  } else {
    if (out_h != ch || out_w != cw) return -1;
    std::memcpy(out, crop.data(), ch * cw * sizeof(float));
  }
  if (value_scale != 1.0) {
    for (int64_t i = 0; i < out_h * out_w; ++i) out[i] *= value_scale;
  }
  return 0;
}

// -------------------------------------------------------- batch gather ----

// Multi-threaded gather of shuffled ray batches from flat buffers:
// out_rays[i] = rays[idx[i]], out_rgbs[i] = rgbs[idx[i]].
// rays: (n, rc) f32, rgbs: (n, cc) f32, idx: (m,) int64.
int ray_gather(const float* rays, const float* rgbs, const int64_t* idx,
               int64_t n, int64_t m, int64_t rc, int64_t cc,
               float* out_rays, float* out_rgbs, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t j = idx[i];
      if (j < 0 || j >= n) continue;
      std::memcpy(out_rays + i * rc, rays + j * rc, rc * sizeof(float));
      std::memcpy(out_rgbs + i * cc, rgbs + j * cc, cc * sizeof(float));
    }
  };
  if (num_threads == 1 || m < 4096) {
    work(0, m);
    return 0;
  }
  std::vector<std::thread> threads;
  int64_t per = (m + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < m ? lo + per : m;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// ------------------------------------------------ imagenet normalize ------

// (h*w, 3) in [0,1] -> ImageNet normalized, in place.
int imagenet_normalize(float* img, int64_t npix) {
  static const float mean[3] = {0.485f, 0.456f, 0.406f};
  static const float stdi[3] = {1.f / 0.229f, 1.f / 0.224f, 1.f / 0.225f};
  for (int64_t i = 0; i < npix; ++i) {
    float* px = img + i * 3;
    px[0] = (px[0] - mean[0]) * stdi[0];
    px[1] = (px[1] - mean[1]) * stdi[1];
    px[2] = (px[2] - mean[2]) * stdi[2];
  }
  return 0;
}

}  // extern "C"
