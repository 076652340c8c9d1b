// Native data-loader runtime: JPEG decode + bilinear resize, C ABI.
// The port's copy of weather_unet_tpu/runtime/jpeg_loader.cc.
//
// The reference leans on torch DataLoader worker *processes* for decode
// throughput; here a libjpeg(-turbo) decode + fused resize runs in C++ with
// the GIL released, so the Python BatchLoader's thread pool achieves real
// parallelism feeding the GPU's host pipeline.
//
// Exposed C ABI (see runtime/__init__.py ctypes binding):
//   wut_decode_file(path, out_size, out_rgb)       -> 0 on success
//   wut_decode_bytes(data, len, out_size, out_rgb) -> 0 on success
//   wut_decode_batch(paths, n, out_size, out, nthreads) -> number decoded
//
// Built by runtime/__init__.py::build only where libjpeg's header and
// library are found (it then defines WUT_HAVE_LIBJPEG for augment.cc too).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "runtime_internal.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Per-axis bilinear taps (align_corners=false, PIL-like pixel centers),
// precomputed once per resize call.
void axis_taps(int in, int out, std::vector<int>* i0, std::vector<float>* wt) {
  i0->resize(out);
  wt->resize(out);
  const float s = static_cast<float>(in) / out;
  for (int o = 0; o < out; ++o) {
    float f = (o + 0.5f) * s - 0.5f;
    int a = std::max(0, std::min(in - 1, static_cast<int>(std::floor(f))));
    (*i0)[o] = a;
    (*wt)[o] = std::max(0.0f, std::min(1.0f, f - a));
  }
}

// Bilinear resize HWC uint8 -> out_size x out_size.  Separable two-pass with
// precomputed per-axis taps: the horizontal pass lerps each SOURCE row once
// into a float strip, the vertical pass blends two strips per output row —
// sequential access, no per-pixel coordinate math (same numerics as the
// per-pixel 4-tap form: bilinear is separable).  Decode-side resize feeds
// the device pipeline which does the exact model-side resizing.
void resize_bilinear(const uint8_t* src, int h, int w, int c,
                     uint8_t* dst, int out) {
  std::vector<int> x0, y0;
  std::vector<float> wx, wy;
  axis_taps(w, out, &x0, &wx);
  axis_taps(h, out, &y0, &wy);

  // horizontal pass: (h, out, c) float strip
  std::vector<float> strip(static_cast<size_t>(h) * out * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * c;
    float* orow = strip.data() + static_cast<size_t>(y) * out * c;
    for (int ox = 0; ox < out; ++ox) {
      const int a = x0[ox];
      const int b = std::min(w - 1, a + 1);
      const float f = wx[ox];
      const uint8_t* pa = row + a * c;
      const uint8_t* pb = row + b * c;
      for (int ch = 0; ch < c; ++ch) {
        orow[ox * c + ch] = pa[ch] + f * (static_cast<float>(pb[ch]) - pa[ch]);
      }
    }
  }
  // vertical pass
  for (int oy = 0; oy < out; ++oy) {
    const int a = y0[oy];
    const int b = std::min(h - 1, a + 1);
    const float f = wy[oy];
    const float* ra = strip.data() + static_cast<size_t>(a) * out * c;
    const float* rb = strip.data() + static_cast<size_t>(b) * out * c;
    uint8_t* orow = dst + static_cast<size_t>(oy) * out * c;
    const int n = out * c;
    for (int i = 0; i < n; ++i) {
      orow[i] = static_cast<uint8_t>(ra[i] + f * (rb[i] - ra[i]) + 0.5f);
    }
  }
}

// DCT-domain downscale: smallest M/8 scale (libjpeg-turbo SIMD scaled IDCTs,
// M in 1..8) whose output stays >= 2x the target - same 2x quality margin,
// finer steps than powers of two (640->224 decodes at 6/8 instead of full
// size).  Single definition for the file- and memory-source decoders.
void set_dct_scale(jpeg_decompress_struct* cinfo, int target_hint) {
  if (target_hint <= 0) return;
  const long full_dim = std::max<long>(cinfo->image_width,
                                       cinfo->image_height);
  unsigned m = 8;
  while (m > 1 && (full_dim * (m - 1) + 7) / 8 >= 2L * target_hint) --m;
  cinfo->scale_num = m;
  cinfo->scale_denom = 8;
}

// Expand a c-component (grayscale) buffer to 3-channel RGB in place.
void expand_to_rgb(std::vector<uint8_t>* full, int w, int h, int c) {
  if (c == 3) return;
  std::vector<uint8_t> expanded(static_cast<size_t>(w) * h * 3);
  for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
    expanded[i * 3] = expanded[i * 3 + 1] = expanded[i * 3 + 2] =
        (*full)[i * c];
  }
  full->swap(expanded);
}

int decode_one(const char* path, int out_size, uint8_t* out_rgb) {
  std::vector<uint8_t> full;
  int h = 0, w = 0;
  int rc = wut::DecodeToRgb(path, out_size, &full, &h, &w);
  if (rc != 0) return rc;
  if (out_size > 0 && (w != out_size || h != out_size)) {
    resize_bilinear(full.data(), h, w, 3, out_rgb, out_size);
  } else {
    std::memcpy(out_rgb, full.data(),
                static_cast<size_t>(out_size) * out_size * 3);
  }
  return 0;
}

}  // namespace

namespace wut {

int DecodeToRgb(const char* path, int target_hint, std::vector<uint8_t>* rgb,
                int* out_h, int* out_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  set_dct_scale(&cinfo, target_hint);
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int c = cinfo.output_components;  // 3 for RGB
  std::vector<uint8_t> full(static_cast<size_t>(w) * h * c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        full.data() + static_cast<size_t>(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  expand_to_rgb(&full, w, h, c);
  rgb->swap(full);
  *out_h = h;
  *out_w = w;
  return 0;
}

int DecodeBytesToRgb(const uint8_t* data, size_t len, int target_hint,
                     std::vector<uint8_t>* rgb, int* out_h, int* out_w) {
  // Memory-source twin of DecodeToRgb (serving uploads arrive as bytes, not
  // paths).  Kept as a sibling rather than factored: setjmp-based libjpeg
  // error recovery must live in the frame owning the cinfo.
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  set_dct_scale(&cinfo, target_hint);
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int c = cinfo.output_components;
  std::vector<uint8_t> full(static_cast<size_t>(w) * h * c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        full.data() + static_cast<size_t>(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  expand_to_rgb(&full, w, h, c);
  rgb->swap(full);
  *out_h = h;
  *out_w = w;
  return 0;
}

}  // namespace wut

extern "C" {

int wut_decode_file(const char* path, int out_size, uint8_t* out_rgb) {
  return decode_one(path, out_size, out_rgb);
}

// Decode a JPEG from memory (HTTP upload) to out_size^2 RGB u8.
int wut_decode_bytes(const uint8_t* data, long len, int out_size,
                     uint8_t* out_rgb) {
  std::vector<uint8_t> full;
  int h = 0, w = 0;
  int rc = wut::DecodeBytesToRgb(data, static_cast<size_t>(len), out_size,
                                 &full, &h, &w);
  if (rc != 0) return rc;
  if (out_size > 0 && (w != out_size || h != out_size)) {
    resize_bilinear(full.data(), h, w, 3, out_rgb, out_size);
  } else {
    std::memcpy(out_rgb, full.data(),
                static_cast<size_t>(out_size) * out_size * 3);
  }
  return 0;
}

// Decode n files in parallel; out is (n, out_size, out_size, 3) contiguous.
// Returns the number of successful decodes; failed slots are zero-filled and
// flagged -1 in ok[i].
int wut_decode_batch(const char** paths, int n, int out_size, uint8_t* out,
                     int* ok, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  // hardware_concurrency() may legally return 0 ("not computable"); without
  // this clamp NO worker would run and the caller's uninitialized out/ok
  // buffers would be returned as if decoded.
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int> next(0), good(0);
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decode_one(paths[i], out_size, out + stride * i);
      ok[i] = rc;
      if (rc == 0) {
        good.fetch_add(1);
      } else {
        std::memset(out + stride * i, 0, stride);
      }
    }
  };
  std::vector<std::thread> threads;
  int nt = std::min(n_threads, n);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

}  // extern "C"
