// Native classification augmenters for the decode stage (pipe.cc):
// resize-shortest-edge, center/random crop, horizontal flip — the subset of
// image.py's CreateAugmenter list that ImageRecordIter(backend='native')
// accepts (reference: src/io/image_aug_default.cc DefaultImageAugmenter,
// python mirror image.py resize_short/scale_down/fixed_crop).
//
// The resampler reproduces Pillow's Resample.c 8bpc path exactly — triangle
// filter, two passes (horizontal then vertical), fixed-point coefficients at
// PRECISION_BITS with per-pass rounding to uint8 — because the PIL path in
// image.py is the correctness oracle: a "close enough" float bilinear would
// put every resized pixel ±1 off the oracle and drown real bugs in the
// parity test's tolerance.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "include/pipe_api.h"

namespace mxt_aug {

// ---- Pillow-parity bilinear resample --------------------------------------

// Pillow src/libImaging/Resample.c: 8 bits for result, 2 for intermediate
// rounding headroom.
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits) << 8) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // per output index: (first input index, count)
  std::vector<int32_t> kk;   // fixed-point weights, ksize per output index
};

// Pillow precompute_coeffs + normalize_coeffs_8bpc for the full-image box.
static Coeffs precompute(int in_size, int out_size) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = filterscale;  // triangle filter support = 1.0
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  Coeffs co;
  co.ksize = ksize;
  co.bounds.resize(static_cast<size_t>(out_size) * 2);
  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    double ww = 0.0;
    int x = 0;
    for (; x < xmax; ++x) {
      double w = triangle_filter((x + xmin - center + 0.5) * ss) * ss;
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    co.bounds[xx * 2 + 0] = xmin;
    co.bounds[xx * 2 + 1] = xmax;
  }
  co.kk.resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); ++i) {
    double v = prekk[i] * (1 << kPrecisionBits);
    co.kk[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
  }
  return co;
}

// horizontal pass: (h, sw, c) -> (h, dw, c)
static void resample_h(const uint8_t* src, int h, int sw, int c,
                       uint8_t* dst, int dw, const Coeffs& co) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in_row = src + static_cast<size_t>(y) * sw * c;
    uint8_t* out_row = dst + static_cast<size_t>(y) * dw * c;
    for (int xx = 0; xx < dw; ++xx) {
      int xmin = co.bounds[xx * 2 + 0];
      int xmax = co.bounds[xx * 2 + 1];
      const int32_t* k = &co.kk[static_cast<size_t>(xx) * co.ksize];
      for (int b = 0; b < c; ++b) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x)
          ss += in_row[(xmin + x) * c + b] * k[x];
        out_row[xx * c + b] = clip8(ss);
      }
    }
  }
}

// vertical pass: (sh, w, c) -> (dh, w, c)
static void resample_v(const uint8_t* src, int w, int c,
                       uint8_t* dst, int dh, const Coeffs& co) {
  for (int yy = 0; yy < dh; ++yy) {
    int ymin = co.bounds[yy * 2 + 0];
    int ymax = co.bounds[yy * 2 + 1];
    const int32_t* k = &co.kk[static_cast<size_t>(yy) * co.ksize];
    uint8_t* out_row = dst + static_cast<size_t>(yy) * w * c;
    for (int x = 0; x < w * c; ++x) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        ss += src[static_cast<size_t>(ymin + y) * w * c + x] * k[y];
      out_row[x] = clip8(ss);
    }
  }
}

void resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, int dh, int dw) {
  if (dh == sh && dw == sw) {  // Pillow skips no-op passes
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * c);
    return;
  }
  if (dw == sw) {
    resample_v(src, sw, c, dst, dh, precompute(sh, dh));
    return;
  }
  if (dh == sh) {
    resample_h(src, sh, sw, c, dst, dw, precompute(sw, dw));
    return;
  }
  // horizontal first, then vertical — Pillow's pass order, and the
  // intermediate rounds to uint8 exactly like Pillow's temp image
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * c);
  resample_h(src, sh, sw, c, tmp.data(), dw, precompute(sw, dw));
  resample_v(tmp.data(), dw, c, dst, dh, precompute(sh, dh));
}

// ---- augmenter chain ------------------------------------------------------

// image.py scale_down: shrink the target rect to fit inside (sw, sh),
// preserving aspect, with the same float->int truncation.
void scale_down(int sw, int sh, int* w, int* h) {
  double tw = *w, th = *h;
  if (sh < th) {
    tw = tw * sh / th;
    th = sh;
  }
  if (sw < tw) {
    th = th * sw / tw;
    tw = sw;
  }
  *w = static_cast<int>(tw);
  *h = static_cast<int>(th);
}

// image.py resize_short_np: shorter edge -> size, integer-floor long edge.
void resize_short_dims(int w, int h, int size, int* nw, int* nh) {
  if (h > w) {
    *nw = size;
    *nh = static_cast<int>(static_cast<int64_t>(size) * h / w);
  } else {
    *nw = static_cast<int>(static_cast<int64_t>(size) * w / h);
    *nh = size;
  }
}

}  // namespace mxt_aug

extern "C" void mxt_resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                                    uint8_t* dst, int dh, int dw) {
  mxt_aug::resize_bilinear(src, sh, sw, c, dst, dh, dw);
}
