// Host-side data-path ops of the port's input pipeline.
//
// The port's own copy of the JAX package's C++ host ops: LUT label
// remapping, the fused uint8 -> f32 normalize, a PIL-exact paired
// crop + resize (+ flip) and the host confusion update, as tight C++ loops
// exposed through ctypes (no pybind11 dependency). Apart from this header
// the source is the JAX package's, and ucd_torch/data/native.py builds it
// with that package's compiler flags, so the two builds give the same bits
// (the normalize's `s * scale + shift` is contracted into an FMA at -O3
// -march=native; other flags move its rounding).
//
// Build: at first use, by ucd_torch/data/native.py (g++, or $CXX), into
// ucd_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(__SSE4_1__)
#include <immintrin.h>
#endif

extern "C" {

// lbl[i] = lut[lbl[i]] for a 256-entry LUT; any value >= 256 maps through
// lut[255]. In-place over an int32 buffer.
void remap_labels_i32(int32_t* lbl, int64_t n, const int32_t* lut) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v = static_cast<uint32_t>(lbl[i]);
    lbl[i] = lut[v < 256u ? v : 255u];
  }
}

// uint8 label buffer -> remapped int32 output.
void remap_labels_u8_to_i32(const uint8_t* src, int32_t* dst, int64_t n,
                            const int32_t* lut) {
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// uint8 HWC image -> float32 HWC, x/255 then (x - mean) / std per channel.
// (reference run.py:51-54 ToTensor+Normalize, fused single pass)
void normalize_u8_to_f32(const uint8_t* src, float* dst, int64_t pixels,
                         int channels, const float* mean, const float* std_) {
  float scale[8], shift[8];
  for (int c = 0; c < channels && c < 8; ++c) {
    scale[c] = 1.0f / (255.0f * std_[c]);
    shift[c] = -mean[c] / std_[c];
  }
  for (int64_t p = 0; p < pixels; ++p) {
    const uint8_t* s = src + p * channels;
    float* d = dst + p * channels;
    for (int c = 0; c < channels; ++c) d[c] = s[c] * scale[c] + shift[c];
  }
}

// ---------------------------------------------------------------------
// PIL-EXACT paired crop+resize(+flip): the geometric core of the train
// pipeline (RandomResizedCrop -> RandomHorizontalFlip, reference
// dataset/transform.py + run.py:49-55). Bit-identical to
// Pillow Image.resize(..., BILINEAR, box=crop) for the image and
// Image.resize(..., NEAREST) of the crop for the label;
// tests/test_torch_native_ops.py holds it against Pillow over seeded shapes.
//
// Image path reimplements Pillow's Resample.c: per-axis triangle filter
// with support scaled by the downscale factor, coefficients rounded to
// fixed point with PRECISION_BITS = 22, horizontal pass first, int32
// accumulation, clip8 rounding after each pass.
// Label path reimplements Pillow's NEAREST affine scaling: incremental
// double accumulation xx += scale starting at 0.5*scale, truncation.

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow Resample.c

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Triangle-filter coefficients for one axis (Pillow precompute_coeffs +
// normalize_coeffs_8bpc). bounds: out x {xmin, xmax}; kk: out x ksize.
int precompute_coeffs(int in_size, int out_size, double in0, double in1,
                      int* bounds, int32_t* kk, int ksize) {
  const double scale = (in1 - in0) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double ss = 1.0 / filterscale;
  const double support = 1.0 * filterscale;  // bilinear support = 1
  double* k = new double[ksize];
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double w = (x + xmin - center + 0.5) * ss;
      w = w < 0 ? -w : w;
      w = w < 1.0 ? 1.0 - w : 0.0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = 0; x < ksize; ++x) {
      const double v = (x < xmax ? k[x] : 0.0) * (1 << kPrecisionBits);
      kk[static_cast<int64_t>(xx) * ksize + x] =
          static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  delete[] k;
  return ksize;
}

inline int ksize_for(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  return static_cast<int>(std::ceil(filterscale)) * 2 + 1;
}

// PIL NEAREST index table: incremental double accumulation (Pillow
// Geometry.c affine scaling path).
void nearest_indices(int in_size, int out_size, int* idx) {
  const double scale = static_cast<double>(in_size) / out_size;
  double xx = 0.5 * scale;
  for (int i = 0; i < out_size; ++i) {
    int v = static_cast<int>(xx);  // trunc
    if (v > in_size - 1) v = in_size - 1;
    idx[i] = v;
    xx += scale;
  }
}

#if defined(__SSE4_1__)
// SIMD RGB resize: same fixed-point math as the scalar path below
// (bit-identical to Pillow), restructured for the vector units. The
// horizontal pass accumulates each output pixel's 3 channels in one
// 4-lane i32 register (4th lane = the next pixel's R byte, discarded)
// and writes an RGBX intermediate; the vertical pass is then a
// contiguous row-major multiply-accumulate the compiler vectorizes at
// full width (AVX-512 on the bench host), with the RGBX->RGB squeeze
// (+ optional horizontal flip) fused into the final clip.
void resize_rgb_simd(const uint8_t* img, uint8_t* img_out,
                     int W, int top, int left, int ch, int cw,
                     int OH, int OW, int flip) {
  const int hks = ksize_for(cw, OW);
  int* hbounds = new int[2 * OW];
  int32_t* hk = new int32_t[static_cast<int64_t>(OW) * hks];
  precompute_coeffs(cw, OW, 0.0, cw, hbounds, hk, hks);

  uint8_t* tmp = new uint8_t[static_cast<int64_t>(ch) * OW * 4];
  // crop row staged into a padded buffer so the 4-byte pixel loads can
  // never read past the caller's image allocation
  uint8_t* rowbuf = new uint8_t[static_cast<int64_t>(cw) * 3 + 16];
  const __m128i bias = _mm_set1_epi32(1 << (kPrecisionBits - 1));
  for (int y = 0; y < ch; ++y) {
    std::memcpy(rowbuf,
                img + (static_cast<int64_t>(top + y) * W + left) * 3,
                static_cast<size_t>(cw) * 3);
    uint8_t* orow = tmp + static_cast<int64_t>(y) * OW * 4;
    for (int xx = 0; xx < OW; ++xx) {
      const int xmin = hbounds[xx * 2], xmax = hbounds[xx * 2 + 1];
      const int32_t* k = hk + static_cast<int64_t>(xx) * hks;
      __m128i acc = bias;
      const uint8_t* p = rowbuf + static_cast<int64_t>(xmin) * 3;
      for (int x = 0; x < xmax; ++x, p += 3) {
        int32_t pix4;
        std::memcpy(&pix4, p, 4);
        const __m128i pix = _mm_cvtepu8_epi32(_mm_cvtsi32_si128(pix4));
        acc = _mm_add_epi32(acc, _mm_mullo_epi32(pix, _mm_set1_epi32(k[x])));
      }
      // srai + saturating packs == clip8 lane-wise (coeffs are >= 0, so
      // the accumulator stays in i32 range; packus clamps to [0, 255])
      acc = _mm_srai_epi32(acc, kPrecisionBits);
      const __m128i p8 = _mm_packus_epi16(_mm_packs_epi32(acc, acc),
                                          _mm_setzero_si128());
      const int32_t out4 = _mm_cvtsi128_si32(p8);
      std::memcpy(orow + static_cast<int64_t>(xx) * 4, &out4, 4);
    }
  }
  delete[] rowbuf;
  delete[] hbounds;
  delete[] hk;

  const int vks = ksize_for(ch, OH);
  int* vbounds = new int[2 * OH];
  int32_t* vk = new int32_t[static_cast<int64_t>(OH) * vks];
  precompute_coeffs(ch, OH, 0.0, ch, vbounds, vk, vks);

  const int n = OW * 4;
  int32_t* acc = new int32_t[n];
  for (int yy = 0; yy < OH; ++yy) {
    const int ymin = vbounds[yy * 2], ymax = vbounds[yy * 2 + 1];
    const int32_t* k = vk + static_cast<int64_t>(yy) * vks;
    for (int j = 0; j < n; ++j) acc[j] = 1 << (kPrecisionBits - 1);
    for (int y = 0; y < ymax; ++y) {
      const uint8_t* src = tmp + static_cast<int64_t>(ymin + y) * n;
      const int32_t kv = k[y];
#pragma GCC ivdep
      for (int j = 0; j < n; ++j)
        acc[j] += static_cast<int32_t>(src[j]) * kv;
    }
    uint8_t* orow = img_out + static_cast<int64_t>(yy) * OW * 3;
    for (int xx = 0; xx < OW; ++xx) {
      const int ox = flip ? (OW - 1 - xx) : xx;
      orow[ox * 3 + 0] = clip8(acc[xx * 4 + 0]);
      orow[ox * 3 + 1] = clip8(acc[xx * 4 + 1]);
      orow[ox * 3 + 2] = clip8(acc[xx * 4 + 2]);
    }
  }
  delete[] acc;
  delete[] vbounds;
  delete[] vk;
  delete[] tmp;
}
#endif  // __SSE4_1__

}  // namespace

// img: uint8 HWC with row stride W*C; lbl: uint8 HW with row stride W.
// Crop window (top, left, ch, cw) -> output (OH, OW); flip mirrors the
// OUTPUT horizontally (== RandomHorizontalFlip after the resize).
void pil_resize_pair_u8(const uint8_t* img, const uint8_t* lbl,
                        uint8_t* img_out, uint8_t* lbl_out,
                        int W, int C, int top, int left, int ch, int cw,
                        int OH, int OW, int flip) {
#if defined(__SSE4_1__)
  if (C == 3) {
    resize_rgb_simd(img, img_out, W, top, left, ch, cw, OH, OW, flip);
    goto label_path;
  }
#endif
  {
  // ---- image (scalar fallback: C != 3 or no SSE4.1): horizontal pass
  // over the ch window rows -> tmp, then vertical pass -> out (Pillow
  // order) --------------------------------------------------------------
  const int hks = ksize_for(cw, OW);
  int* hbounds = new int[2 * OW];
  int32_t* hk = new int32_t[static_cast<int64_t>(OW) * hks];
  precompute_coeffs(cw, OW, 0.0, cw, hbounds, hk, hks);

  uint8_t* tmp = new uint8_t[static_cast<int64_t>(ch) * OW * C];
  for (int y = 0; y < ch; ++y) {
    const uint8_t* row = img + (static_cast<int64_t>(top + y) * W + left) * C;
    uint8_t* orow = tmp + static_cast<int64_t>(y) * OW * C;
    for (int xx = 0; xx < OW; ++xx) {
      const int xmin = hbounds[xx * 2], xmax = hbounds[xx * 2 + 1];
      const int32_t* k = hk + static_cast<int64_t>(xx) * hks;
      for (int c = 0; c < C; ++c) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x)
          ss += row[(xmin + x) * C + c] * k[x];
        orow[xx * C + c] = clip8(ss);
      }
    }
  }
  delete[] hbounds;
  delete[] hk;

  const int vks = ksize_for(ch, OH);
  int* vbounds = new int[2 * OH];
  int32_t* vk = new int32_t[static_cast<int64_t>(OH) * vks];
  precompute_coeffs(ch, OH, 0.0, ch, vbounds, vk, vks);

  for (int yy = 0; yy < OH; ++yy) {
    const int ymin = vbounds[yy * 2], ymax = vbounds[yy * 2 + 1];
    const int32_t* k = vk + static_cast<int64_t>(yy) * vks;
    uint8_t* orow = img_out + static_cast<int64_t>(yy) * OW * C;
    for (int xx = 0; xx < OW; ++xx) {
      const int ox = flip ? (OW - 1 - xx) : xx;
      for (int c = 0; c < C; ++c) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; ++y)
          ss += tmp[(static_cast<int64_t>(ymin + y) * OW + xx) * C + c] * k[y];
        orow[ox * C + c] = clip8(ss);
      }
    }
  }
  delete[] vbounds;
  delete[] vk;
  delete[] tmp;
  }

#if defined(__SSE4_1__)
label_path:
#endif
  // ---- label: PIL NEAREST of the crop window -------------------------
  {
  int* xi = new int[OW];
  int* yi = new int[OH];
  nearest_indices(cw, OW, xi);
  nearest_indices(ch, OH, yi);
  for (int yy = 0; yy < OH; ++yy) {
    const uint8_t* row = lbl + static_cast<int64_t>(top + yi[yy]) * W + left;
    uint8_t* orow = lbl_out + static_cast<int64_t>(yy) * OW;
    if (!flip) {
      for (int xx = 0; xx < OW; ++xx) orow[xx] = row[xi[xx]];
    } else {
      for (int xx = 0; xx < OW; ++xx) orow[OW - 1 - xx] = row[xi[xx]];
    }
  }
  delete[] xi;
  delete[] yi;
  }
}

// Streaming confusion-matrix accumulation on the host (for CPU-side eval
// paths; the device path uses the jit bincount). hist is n x n int64.
void confusion_update_i32(const int32_t* lbl, const int32_t* pred, int64_t n,
                          int n_classes, int64_t* hist) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t t = lbl[i];
    if (t >= 0 && t < n_classes) {
      hist[static_cast<int64_t>(t) * n_classes + pred[i]] += 1;
    }
  }
}

}  // extern "C"
