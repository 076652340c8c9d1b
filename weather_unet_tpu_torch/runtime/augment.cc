// Native fused train augmentation: decode -> one inverse-affine bilinear
// resample (rotation o resized-crop o hflip) -> color jitter -> u8.
// The port's copy of weather_unet_tpu/runtime/augment.cc.
//
// This is the host-side twin of the on-device kernel in
// data/transforms.py (`_one_affine` / `_affine_sample` / `_color_jitter`):
// the same single composed affine map and the same jitter formulas, executed
// in C++ with the GIL released so the BatchLoader thread pool scales on
// multi-core hosts.  It replaces the reference's per-sample torchvision CPU
// stack (t_cls_train.py:81-102: RandomRotation(10) -> RandomResizedCrop |
// Resize -> RandomHorizontalFlip -> ColorJitter) with one resample pass
// instead of three, and fuses the JPEG decode into the same call.
//
// Randomness stays in Python: the caller samples per-image uniforms (for the
// affine) and jitter factors and passes them in, so runs are deterministic
// and the affine construction can be pinned against the JAX implementation
// in tests (tests/test_torch_runtime.py).
//
// C ABI (see runtime/__init__.py ctypes binding):
//   wut_make_affine(h, w, u6, cfg..., out_size, mat6)  — affine from uniforms
//   wut_augment_u8(src, h, w, mat6, jitter3, out_size, out)
//   wut_decode_augment_file(path, u6, jitter3, cfg..., out_size, out)
//     (only with WUT_HAVE_LIBJPEG: the decode lives in jpeg_loader.cc, which
//     is built only where libjpeg is found; without it this file builds and
//     loads alone and exports the first two entries)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "runtime_internal.h"

namespace {

constexpr float kPi = 3.14159265358979323846f;

// Mirror of data/transforms.py::affine_from_uniforms — the inverse map
// out-pixel -> source-pixel as a 2x3 row-major matrix [[a11 a12 a13],
// [a21 a22 a23]] applied to (x_out, y_out, 1).
void MakeAffine(int in_h, int in_w, const float* u, float degrees,
                int resized_crop, float scale_lo, float scale_hi,
                float ratio_lo, float ratio_hi, int hflip, int out_size,
                float* mat) {
  const float u_rot = u[0], u_scale = u[1], u_ratio = u[2];
  const float u_posx = u[3], u_posy = u[4], u_flip = u[5];

  float cw, ch, cx0, cy0;
  if (resized_crop) {
    const float area = static_cast<float>(in_h) * static_cast<float>(in_w);
    const float scale = scale_lo + u_scale * (scale_hi - scale_lo);
    const float log_ratio = std::log(ratio_lo) +
                            u_ratio * (std::log(ratio_hi) - std::log(ratio_lo));
    const float ratio = std::exp(log_ratio);
    cw = std::min(std::max(std::sqrt(area * scale * ratio), 1.0f),
                  static_cast<float>(in_w));
    ch = std::min(std::max(std::sqrt(area * scale / ratio), 1.0f),
                  static_cast<float>(in_h));
    cx0 = u_posx * (in_w - cw);
    cy0 = u_posy * (in_h - ch);
  } else {
    cw = static_cast<float>(in_w);
    ch = static_cast<float>(in_h);
    cx0 = cy0 = 0.0f;
  }

  const float sx = cw / out_size;
  const float sy = ch / out_size;

  const float theta = (-degrees + u_rot * 2.0f * degrees) * (kPi / 180.0f);
  const float c = std::cos(theta), s = std::sin(theta);
  const float cx = (in_w - 1) / 2.0f;
  const float cy = (in_h - 1) / 2.0f;

  const bool flip = hflip && (u_flip < 0.5f);
  const float fsign = flip ? -1.0f : 1.0f;
  const float foff = flip ? out_size - 1.0f : 0.0f;

  mat[0] = c * fsign * sx;
  mat[1] = -s * sy;
  mat[2] = c * (foff * sx + cx0 - cx) - s * (cy0 - cy) + cx;
  mat[3] = s * fsign * sx;
  mat[4] = c * sy;
  mat[5] = s * (foff * sx + cx0 - cx) + c * (cy0 - cy) + cy;
}

// One bilinear tap with per-tap zero outside the source (checked; border
// pixels only — the interior inner loop below is branch-free).
inline void TapChecked(const uint8_t* src, int h, int w, float sxf, float syf,
                       float* rgb) {
  const float x0f = std::floor(sxf), y0f = std::floor(syf);
  const float fx = sxf - x0f, fy = syf - y0f;
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  rgb[0] = rgb[1] = rgb[2] = 0.0f;
  const float tw[4] = {(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                       fx * fy};
  const int tx[4] = {x0, x0 + 1, x0, x0 + 1};
  const int ty[4] = {y0, y0, y0 + 1, y0 + 1};
  for (int t = 0; t < 4; ++t) {
    if (ty[t] < 0 || ty[t] >= h || tx[t] < 0 || tx[t] >= w) continue;
    const uint8_t* p = src + (static_cast<size_t>(ty[t]) * w + tx[t]) * 3;
    rgb[0] += tw[t] * p[0];
    rgb[1] += tw[t] * p[1];
    rgb[2] += tw[t] * p[2];
  }
}

// Largest ox interval [lo, hi) of a row where ALL four taps are in-bounds
// (x0 in [0, w-2], y0 in [0, h-2]); coordinates are affine in ox, so the
// valid set is the intersection of two intervals.  Conservative: endpoints
// are re-verified and shrunk, so float rounding can never admit an
// out-of-bounds tap into the branch-free loop.
inline void InteriorRange(float rowx, float rowy, float dx, float dy, int h,
                          int w, int out_size, int* lo, int* hi) {
  double l = 0.0, r = static_cast<double>(out_size);
  auto clip = [&](double c, double d, double vmax) {
    // need c + d*ox in [0, vmax)
    if (d > 1e-12 || d < -1e-12) {
      double a = (0.0 - c) / d, b = (vmax - c) / d;
      if (a > b) std::swap(a, b);
      l = std::max(l, a);
      r = std::min(r, b);
    } else if (c < 0.0 || c >= vmax) {
      r = l;  // whole row is border
    }
  };
  clip(rowx, dx, static_cast<double>(w - 1));
  clip(rowy, dy, static_cast<double>(h - 1));
  // clamp into [0, out_size] BEFORE the int casts: an interval entirely
  // past the row (l > out_size) or huge values from a tiny |d| must not
  // reach the cast (int overflow) or the border loops (buffer overrun)
  const double out_d = static_cast<double>(out_size);
  int lo_i = static_cast<int>(std::min(std::ceil(std::max(l, 0.0)), out_d));
  int hi_i = static_cast<int>(
      std::max(std::min(std::floor(std::min(r, out_d)), out_d), 0.0));
  if (hi_i < lo_i) hi_i = lo_i;
  auto ok = [&](int ox) {
    const float sx = rowx + dx * ox, sy = rowy + dy * ox;
    const int x0 = static_cast<int>(std::floor(sx));
    const int y0 = static_cast<int>(std::floor(sy));
    return x0 >= 0 && x0 + 1 <= w - 1 && y0 >= 0 && y0 + 1 <= h - 1;
  };
  while (lo_i < hi_i && !ok(lo_i)) ++lo_i;
  while (hi_i > lo_i && !ok(hi_i - 1)) --hi_i;
  *lo = lo_i;
  *hi = std::max(hi_i, lo_i);
}

inline uint8_t ClampU8(float v) {
  return static_cast<uint8_t>(std::min(std::max(v, 0.0f), 255.0f) + 0.5f);
}

// Mirror of data/transforms.py::_affine_sample (4-tap bilinear, per-tap
// zero outside the source) + _color_jitter (fixed brightness -> contrast ->
// saturation order, ITU-R 601 luma).  Jitter factors < 0 are disabled; with
// all three disabled the resample writes u8 directly (no scratch pass) —
// the default train config (rotation/crop/flip, no color jitter).
// Jitter math runs on the [0, 255] scale: every formula is linear, so it is
// the [0, 1] computation scaled by 255 with the clip rescaled accordingly.
void AugmentU8(const uint8_t* src, int h, int w, const float* mat,
               const float* jitter, int out_size, uint8_t* out,
               std::vector<float>* scratch) {
  const float fb = jitter[0], fc = jitter[1], fs = jitter[2];
  const bool any_jitter = fb >= 0.0f || fc >= 0.0f || fs >= 0.0f;
  const float dx = mat[0], dy = mat[3];

  float* buf = nullptr;
  if (any_jitter) {
    scratch->resize(static_cast<size_t>(out_size) * out_size * 3);
    buf = scratch->data();
  }

  double gray_sum = 0.0;  // mean luma for the contrast formula
  for (int oy = 0; oy < out_size; ++oy) {
    const float rowx = mat[1] * oy + mat[2];
    const float rowy = mat[4] * oy + mat[5];
    int lo, hi;
    InteriorRange(rowx, rowy, dx, dy, h, w, out_size, &lo, &hi);

    uint8_t* orow = out + static_cast<size_t>(oy) * out_size * 3;
    float* frow = buf ? buf + static_cast<size_t>(oy) * out_size * 3 : nullptr;

    for (int ox = 0; ox < lo; ++ox) {  // left border (checked taps)
      float rgb[3];
      TapChecked(src, h, w, rowx + dx * ox, rowy + dy * ox, rgb);
      if (frow) {
        frow[ox * 3] = rgb[0];
        frow[ox * 3 + 1] = rgb[1];
        frow[ox * 3 + 2] = rgb[2];
        gray_sum += 0.299f * rgb[0] + 0.587f * rgb[1] + 0.114f * rgb[2];
      } else {
        orow[ox * 3] = ClampU8(rgb[0]);
        orow[ox * 3 + 1] = ClampU8(rgb[1]);
        orow[ox * 3 + 2] = ClampU8(rgb[2]);
      }
    }
    // interior: all four taps in-bounds, branch-free
    for (int ox = lo; ox < hi; ++ox) {
      const float sxf = rowx + dx * ox;
      const float syf = rowy + dy * ox;
      const int x0 = static_cast<int>(sxf);  // sxf >= 0 here: cast == floor
      const int y0 = static_cast<int>(syf);
      const float fx = sxf - x0, fy = syf - y0;
      const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
      const float w10 = (1 - fx) * fy, w11 = fx * fy;
      const uint8_t* p0 = src + (static_cast<size_t>(y0) * w + x0) * 3;
      const uint8_t* p1 = p0 + static_cast<size_t>(w) * 3;
      const float r = w00 * p0[0] + w01 * p0[3] + w10 * p1[0] + w11 * p1[3];
      const float g = w00 * p0[1] + w01 * p0[4] + w10 * p1[1] + w11 * p1[4];
      const float b = w00 * p0[2] + w01 * p0[5] + w10 * p1[2] + w11 * p1[5];
      if (frow) {
        frow[ox * 3] = r;
        frow[ox * 3 + 1] = g;
        frow[ox * 3 + 2] = b;
        gray_sum += 0.299f * r + 0.587f * g + 0.114f * b;
      } else {
        orow[ox * 3] = static_cast<uint8_t>(r + 0.5f);  // convex: in-range
        orow[ox * 3 + 1] = static_cast<uint8_t>(g + 0.5f);
        orow[ox * 3 + 2] = static_cast<uint8_t>(b + 0.5f);
      }
    }
    for (int ox = hi; ox < out_size; ++ox) {  // right border
      float rgb[3];
      TapChecked(src, h, w, rowx + dx * ox, rowy + dy * ox, rgb);
      if (frow) {
        frow[ox * 3] = rgb[0];
        frow[ox * 3 + 1] = rgb[1];
        frow[ox * 3 + 2] = rgb[2];
        gray_sum += 0.299f * rgb[0] + 0.587f * rgb[1] + 0.114f * rgb[2];
      } else {
        orow[ox * 3] = ClampU8(rgb[0]);
        orow[ox * 3 + 1] = ClampU8(rgb[1]);
        orow[ox * 3 + 2] = ClampU8(rgb[2]);
      }
    }
  }
  if (!any_jitter) return;

  // jitter epilogue on the [0, 255] scale (gray_sum is on that scale too)
  const float gray_mean =
      static_cast<float>(gray_sum / (static_cast<double>(out_size) * out_size));
  // _color_jitter computes the contrast gray mean AFTER brightness; the
  // brightness factor folds into the pre-jitter mean (pure scale, no
  // intermediate clipping).
  const float gray_mean_c = (fb >= 0.0f) ? fb * gray_mean : gray_mean;

  const size_t n_px = static_cast<size_t>(out_size) * out_size;
  for (size_t i = 0; i < n_px; ++i) {
    float r = buf[i * 3], g = buf[i * 3 + 1], b = buf[i * 3 + 2];
    if (fb >= 0.0f) {
      r *= fb;
      g *= fb;
      b *= fb;
    }
    if (fc >= 0.0f) {
      const float add = (1.0f - fc) * gray_mean_c;
      r = fc * r + add;
      g = fc * g + add;
      b = fc * b + add;
    }
    if (fs >= 0.0f) {
      const float gray = 0.299f * r + 0.587f * g + 0.114f * b;
      const float add = (1.0f - fs) * gray;
      r = fs * r + add;
      g = fs * g + add;
      b = fs * b + add;
    }
    out[i * 3] = ClampU8(r);
    out[i * 3 + 1] = ClampU8(g);
    out[i * 3 + 2] = ClampU8(b);
  }
}

}  // namespace

extern "C" {

void wut_make_affine(int h, int w, const float* u6, float degrees,
                     int resized_crop, float scale_lo, float scale_hi,
                     float ratio_lo, float ratio_hi, int hflip, int out_size,
                     float* mat6) {
  MakeAffine(h, w, u6, degrees, resized_crop, scale_lo, scale_hi, ratio_lo,
             ratio_hi, hflip, out_size, mat6);
}

int wut_augment_u8(const uint8_t* src, int h, int w, const float* mat6,
                   const float* jitter3, int out_size, uint8_t* out) {
  if (h <= 0 || w <= 0 || out_size <= 0) return -1;
  std::vector<float> scratch;
  AugmentU8(src, h, w, mat6, jitter3, out_size, out, &scratch);
  return 0;
}

#ifdef WUT_HAVE_LIBJPEG
int wut_decode_augment_file(const char* path, const float* u6,
                            const float* jitter3, float degrees,
                            int resized_crop, float scale_lo, float scale_hi,
                            float ratio_lo, float ratio_hi, int hflip,
                            int out_size, uint8_t* out) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  int rc = wut::DecodeToRgb(path, out_size, &rgb, &h, &w);
  if (rc != 0) return rc;
  float mat[6];
  MakeAffine(h, w, u6, degrees, resized_crop, scale_lo, scale_hi, ratio_lo,
             ratio_hi, hflip, out_size, mat);
  std::vector<float> scratch;
  AugmentU8(rgb.data(), h, w, mat, jitter3, out_size, out, &scratch);
  return 0;
}
#endif  // WUT_HAVE_LIBJPEG

}  // extern "C"
