// Fused bilinear upsample + CE/KD loss, forward and backward, for Hopper
// (sm_90a).
//
// Replaces ucd_tpu/ops/fused_loss.py::_loss_kernel (forward) and
// ::_grad_kernel (backward), the Pallas kernels of the JAX train and
// validate steps. Same function: bilinearly upsample the new model's
// low-res logits z (B, h, w, C) and the frozen old model's tz (B, h, w, Co)
// to the label size (H, W) with half-pixel centres and edge clamping, and
// evaluate per output pixel
//
//   CE   : lse(z) - z[label]                        (ce)
//          lse(z) - (label' == 0 ? lse(z[:old_cl]) : z[label'])   (unce,
//          label' = 0 where label < old_cl), over pixels whose label != 255
//   KD   : sum_{c<Co} lam_c z_c - lse(z[:Co])                      (kd)
//          lam_0 (lse(z[{0} u >=Co]) - lse(z))
//            + sum_{1<=c<Co} lam_c (z_c - lse(z))                  (unkd)
//          with lam = softmax(alpha * tz), over every pixel
//
// summed over pixels (the wrapper divides by B*H*W, and by -Co*B*H*W for
// KD). Neither the upsampled (B, H, W, C) logits nor their gradient is ever
// written to device memory.
//
// Each log-sum-exp is stabilized with the maximum of its own class subset:
// one max per pixel would underflow a subset whose logits all lie far below
// it.
//
// Forward (`fused_loss_fwd_kernel`). Bound: operations. At the train shape
// (8, 32, 32, 17) + (8, 32, 32, 16) -> (8, 512, 512) it must read 1.1 MB of
// logits and 2.1 MB of uint8 labels (about 1 us of memory time) but
// evaluates ~50 exp and ~250 flops per output pixel. The TPU kernel's width
// dot against a dense interpolation matrix and its 3-slot row windows are
// answers to the MXU and VMEM; here the upsample is a 4-tap gather from 1-D
// tap tables (index0, index1, frac) built on the host, computed inside the
// kernel. Design: one thread per output pixel, blockIdx.y the output row and
// blockIdx.z the image (row taps uniform across a block, neighbouring
// threads share source pixels through L1); pass 1 over the classes finds
// each subset's max, pass 2 the sums, each pass re-forming the upsampled
// logit from its 4 taps, so a pixel needs no per-class storage and any class
// count works; a warp-shuffle + shared-memory block reduction writes one
// partial per block and term, which the wrapper sums.
//
// Backward (`fused_loss_bwd_kernel`). Bound: operations (the same
// recomputation, about four times over). The gradient goes to the low-res
// logits, so many output pixels add into one source pixel. To keep the fold
// deterministic without float atomics the scatter is turned into a gather:
// one block per source pixel (b, i, j) walks the output pixels that tap it
// -- the contiguous row range [ylo[i], yhi[i]) and column range
// [xlo[j], xhi[j]) that the host derives from the tap tables, clamped edge
// taps included -- recomputes each pixel's softmax terms, weights the
// analytic gradient by the pixel's bilinear weight onto (i, j) (both taps of
// a clamped edge add), accumulates per class in a per-thread array and
// reduces the block per class in a fixed order. Each output pixel is
// recomputed by the (up to) four source pixels it taps. The per-thread
// accumulator is indexed by class at run time, so it lives in local memory
// (up to MAX_CLASSES floats).
//
// C interface (ctypes): each entry returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an argument the kernels do not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_CLASSES 256

namespace {

enum { CE_PLAIN = 0, CE_UNCE = 1 };
enum { KD_NONE = 0, KD_KD = 1, KD_UNKD = 2 };
constexpr int IGNORE = 255;
constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;

// The four source pixels of one output pixel and their weights, in the
// form of torch.nn.functional.interpolate(bilinear, align_corners=False):
// hy*(hx*a + lx*b) + ly*(hx*c + lx*d).
struct Taps {
  const float* p00;
  const float* p01;
  const float* p10;
  const float* p11;
  float hy, ly, hx, lx;
};

__device__ __forceinline__ Taps make_taps(const float* base, int b, int h,
                                          int w, int C, int y0, int y1,
                                          float fy, int x0, int x1,
                                          float fx) {
  Taps t;
  const int64_t row0 = ((int64_t)b * h + y0) * w;
  const int64_t row1 = ((int64_t)b * h + y1) * w;
  t.p00 = base + (row0 + x0) * C;
  t.p01 = base + (row0 + x1) * C;
  t.p10 = base + (row1 + x0) * C;
  t.p11 = base + (row1 + x1) * C;
  t.ly = fy;
  t.hy = 1.0f - fy;
  t.lx = fx;
  t.hx = 1.0f - fx;
  return t;
}

__device__ __forceinline__ float up(const Taps& t, int c) {
  return t.hy * (t.hx * __ldg(t.p00 + c) + t.lx * __ldg(t.p01 + c)) +
         t.ly * (t.hx * __ldg(t.p10 + c) + t.lx * __ldg(t.p11 + c));
}

// Softmax pieces of one output pixel. `sub` is the KD subset of the new
// logits: classes < Co (kd) or {0} u classes >= Co (unkd).
struct Stats {
  float m_all, s_all;  // all classes of z
  float m_old, s_old;  // classes < old_cl (unce)
  float m_sub, s_sub;  // KD subset of z
  float m_t, s_t;      // alpha * tz over its Co classes
  float sel;           // z[safe]
  float e_t0;          // exp(alpha*tz_0 - m_t)
  float s_mid;         // sum_{1<=c<Co} exp(alpha*tz_c - m_t)
  float t2;            // sum e_t_c * z_c over c<Co (kd) or 1<=c<Co (unkd)
};

template <int KD>
__device__ __forceinline__ bool in_sub(int c, int Co) {
  return KD == KD_KD ? (c < Co) : (c == 0 || c >= Co);
}

template <int CE, int KD>
__device__ __forceinline__ Stats pixel_stats(const Taps& zt, const Taps& tt,
                                             int C, int Co, int old_cl,
                                             float alpha, int safe) {
  Stats s;
  s.m_all = s.m_old = s.m_sub = s.m_t = -INFINITY;
  for (int c = 0; c < C; ++c) {
    const float v = up(zt, c);
    s.m_all = fmaxf(s.m_all, v);
    if (CE == CE_UNCE && c < old_cl) s.m_old = fmaxf(s.m_old, v);
    if (KD != KD_NONE && in_sub<KD>(c, Co)) s.m_sub = fmaxf(s.m_sub, v);
  }
  if (KD != KD_NONE) {
    for (int c = 0; c < Co; ++c) s.m_t = fmaxf(s.m_t, alpha * up(tt, c));
  }
  s.s_all = s.s_old = s.s_sub = s.s_t = 0.0f;
  s.sel = s.e_t0 = s.s_mid = s.t2 = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float v = up(zt, c);
    s.s_all += expf(v - s.m_all);
    if (c == safe) s.sel = v;
    if (CE == CE_UNCE && c < old_cl) s.s_old += expf(v - s.m_old);
    if (KD != KD_NONE) {
      if (in_sub<KD>(c, Co)) s.s_sub += expf(v - s.m_sub);
      if (c < Co) {
        const float e = expf(alpha * up(tt, c) - s.m_t);
        s.s_t += e;
        if (c == 0) s.e_t0 = e;
        if (c >= 1) s.s_mid += e;
        if (KD == KD_KD || c >= 1) s.t2 += e * v;
      }
    }
  }
  return s;
}

// label' of the CE term and whether the pixel counts (label != 255)
template <int CE>
__device__ __forceinline__ int safe_label(int lab, int old_cl, int C,
                                          bool* valid) {
  *valid = lab != IGNORE;
  int l = *valid ? lab : 0;
  if (CE == CE_UNCE && l < old_cl) l = 0;
  return min(max(l, 0), C - 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int CE, int KD, typename L>
__global__ void __launch_bounds__(FWD_THREADS)
    fused_loss_fwd_kernel(const float* __restrict__ z,
                          const float* __restrict__ tz,
                          const L* __restrict__ labels,
                          const int32_t* __restrict__ iy0,
                          const int32_t* __restrict__ iy1,
                          const float* __restrict__ fy,
                          const int32_t* __restrict__ ix0,
                          const int32_t* __restrict__ ix1,
                          const float* __restrict__ fx,
                          float* __restrict__ ce_part,
                          float* __restrict__ kd_part, int h, int w, int C,
                          int Co, int H, int W, int old_cl, float alpha) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  float ce = 0.0f, kd = 0.0f;
  if (x < W) {
    const int y0 = iy0[y], y1 = iy1[y], x0 = ix0[x], x1 = ix1[x];
    const float ly = fy[y], lx = fx[x];
    const Taps zt = make_taps(z, b, h, w, C, y0, y1, ly, x0, x1, lx);
    Taps tt = zt;
    if (KD != KD_NONE) tt = make_taps(tz, b, h, w, Co, y0, y1, ly, x0, x1, lx);
    bool valid;
    const int lab = (int)labels[((int64_t)b * H + y) * W + x];
    const int safe = safe_label<CE>(lab, old_cl, C, &valid);
    const Stats s = pixel_stats<CE, KD>(zt, tt, C, Co, old_cl, alpha, safe);
    const float den = s.m_all + logf(s.s_all);
    if (valid) {
      float sel = s.sel;
      if (CE == CE_UNCE && safe == 0) sel = s.m_old + logf(s.s_old);
      ce = den - sel;
    }
    if (KD == KD_KD) {
      kd = s.t2 / s.s_t - (s.m_sub + logf(s.s_sub));
    } else if (KD == KD_UNKD) {
      const float inv = 1.0f / s.s_t;
      const float lse_bn = s.m_sub + logf(s.s_sub);
      kd = s.e_t0 * inv * (lse_bn - den) + s.t2 * inv - s.s_mid * inv * den;
    }
  }
  __shared__ float sm_ce[FWD_THREADS / 32];
  __shared__ float sm_kd[FWD_THREADS / 32];
  ce = warp_sum(ce);
  kd = warp_sum(kd);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm_ce[warp] = ce;
    sm_kd[warp] = kd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, k = 0.0f;
    for (int i = 0; i < FWD_THREADS / 32; ++i) {
      a += sm_ce[i];
      k += sm_kd[i];
    }
    const int64_t blk =
        ((int64_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    ce_part[blk] = a;
    kd_part[blk] = k;
  }
}

template <int CE, int KD, typename L>
__global__ void __launch_bounds__(BWD_THREADS)
    fused_loss_bwd_kernel(const float* __restrict__ z,
                          const float* __restrict__ tz,
                          const L* __restrict__ labels,
                          const int32_t* __restrict__ iy0,
                          const int32_t* __restrict__ iy1,
                          const float* __restrict__ fy,
                          const int32_t* __restrict__ ix0,
                          const int32_t* __restrict__ ix1,
                          const float* __restrict__ fx,
                          const int32_t* __restrict__ ylo,
                          const int32_t* __restrict__ yhi,
                          const int32_t* __restrict__ xlo,
                          const int32_t* __restrict__ xhi,
                          const float* __restrict__ coefs,
                          float* __restrict__ dz, int h, int w, int C, int Co,
                          int H, int W, int old_cl, float alpha) {
  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const float coef_ce = coefs[0], coef_kd = coefs[1];
  const int y_begin = ylo[i], ny = yhi[i] - y_begin;
  const int x_begin = xlo[j], nx = xhi[j] - x_begin;

  float acc[MAX_CLASSES];
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int p = threadIdx.x; p < ny * nx; p += BWD_THREADS) {
    const int y = y_begin + p / nx;
    const int x = x_begin + p % nx;
    const int y0 = iy0[y], y1 = iy1[y], x0 = ix0[x], x1 = ix1[x];
    const float ly = fy[y], lx = fx[x];
    // this pixel's bilinear weight onto source (i, j); both taps of a
    // clamped edge land on the same source and add
    const float wy = (y0 == i ? 1.0f - ly : 0.0f) + (y1 == i ? ly : 0.0f);
    const float wx = (x0 == j ? 1.0f - lx : 0.0f) + (x1 == j ? lx : 0.0f);
    const float wt = wy * wx;
    if (wt == 0.0f) continue;

    const Taps zt = make_taps(z, b, h, w, C, y0, y1, ly, x0, x1, lx);
    Taps tt = zt;
    if (KD != KD_NONE) tt = make_taps(tz, b, h, w, Co, y0, y1, ly, x0, x1, lx);
    bool valid;
    const int lab = (int)labels[((int64_t)b * H + y) * W + x];
    const int safe = safe_label<CE>(lab, old_cl, C, &valid);
    const Stats s = pixel_stats<CE, KD>(zt, tt, C, Co, old_cl, alpha, safe);
    const float inv_all = 1.0f / s.s_all;
    const float inv_old = CE == CE_UNCE ? 1.0f / s.s_old : 0.0f;
    const float inv_sub = KD != KD_NONE ? 1.0f / s.s_sub : 0.0f;
    const float inv_t = KD != KD_NONE ? 1.0f / s.s_t : 0.0f;
    const float lam0 = s.e_t0 * inv_t;
    const float w_ce = valid ? wt * coef_ce : 0.0f;
    const float w_kd = wt * coef_kd;

    for (int c = 0; c < C; ++c) {
      const float v = up(zt, c);
      const float pc = expf(v - s.m_all) * inv_all;  // softmax(z)_c
      float d_sel;
      if (CE == CE_UNCE && safe == 0)
        d_sel = c < old_cl ? expf(v - s.m_old) * inv_old : 0.0f;
      else
        d_sel = c == safe ? 1.0f : 0.0f;
      float g = w_ce * (pc - d_sel);
      if (KD != KD_NONE) {
        const float sub =
            in_sub<KD>(c, Co) ? expf(v - s.m_sub) * inv_sub : 0.0f;
        const float lam =
            c < Co ? expf(alpha * up(tt, c) - s.m_t) * inv_t : 0.0f;
        float g_kd;
        if (KD == KD_UNKD)
          g_kd = lam0 * sub + (c >= 1 ? lam : 0.0f) - pc;
        else
          g_kd = lam - sub;
        g += w_kd * g_kd;
      }
      acc[c] += g;
    }
  }

  // block reduction per class in a fixed order: shuffles inside each warp,
  // then the warps' sums added in warp order
  __shared__ float sm[BWD_THREADS / 32][MAX_CLASSES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < C; ++c) {
    const float v = warp_sum(acc[c]);
    if (lane == 0) sm[warp][c] = v;
  }
  __syncthreads();
  float* out = dz + (((int64_t)b * h + i) * w + j) * C;
  for (int c = threadIdx.x; c < C; c += BWD_THREADS) {
    float v = 0.0f;
    for (int k = 0; k < BWD_THREADS / 32; ++k) v += sm[k][c];
    out[c] = v;
  }
}

struct Args {
  const float* z;
  const float* tz;
  const void* labels;
  const int32_t *iy0, *iy1;
  const float* fy;
  const int32_t *ix0, *ix1;
  const float* fx;
  int B, h, w, C, Co, H, W, old_cl;
  float alpha;
  cudaStream_t stream;
};

template <int CE, int KD, typename L>
void launch_fwd(const Args& a, float* ce_part, float* kd_part) {
  const dim3 grid((a.W + FWD_THREADS - 1) / FWD_THREADS, a.H, a.B);
  fused_loss_fwd_kernel<CE, KD, L><<<grid, FWD_THREADS, 0, a.stream>>>(
      a.z, a.tz, (const L*)a.labels, a.iy0, a.iy1, a.fy, a.ix0, a.ix1, a.fx,
      ce_part, kd_part, a.h, a.w, a.C, a.Co, a.H, a.W, a.old_cl, a.alpha);
}

template <int CE, int KD, typename L>
void launch_bwd(const Args& a, const int32_t* ylo, const int32_t* yhi,
                const int32_t* xlo, const int32_t* xhi, const float* coefs,
                float* dz) {
  const dim3 grid(a.w, a.h, a.B);
  fused_loss_bwd_kernel<CE, KD, L><<<grid, BWD_THREADS, 0, a.stream>>>(
      a.z, a.tz, (const L*)a.labels, a.iy0, a.iy1, a.fy, a.ix0, a.ix1, a.fx,
      ylo, yhi, xlo, xhi, coefs, dz, a.h, a.w, a.C, a.Co, a.H, a.W, a.old_cl,
      a.alpha);
}

// run `F<CE, KD, L>` for the run-time (ce_mode, kd_mode, label type)
#define DISPATCH_MODES(FN, L, ...)                                     \
  switch (ce_mode * 3 + kd_mode) {                                     \
    case 0: FN<CE_PLAIN, KD_NONE, L>(__VA_ARGS__); break;              \
    case 1: FN<CE_PLAIN, KD_KD, L>(__VA_ARGS__); break;                \
    case 2: FN<CE_PLAIN, KD_UNKD, L>(__VA_ARGS__); break;              \
    case 3: FN<CE_UNCE, KD_NONE, L>(__VA_ARGS__); break;               \
    case 4: FN<CE_UNCE, KD_KD, L>(__VA_ARGS__); break;                 \
    case 5: FN<CE_UNCE, KD_UNKD, L>(__VA_ARGS__); break;               \
  }

bool args_ok(const Args& a, int ce_mode, int kd_mode, int label_bytes) {
  if (ce_mode < 0 || ce_mode > 1 || kd_mode < 0 || kd_mode > 2) return false;
  if (label_bytes != 1 && label_bytes != 4) return false;
  if (a.C < 1 || a.C > MAX_CLASSES) return false;
  if (ce_mode == CE_UNCE && (a.old_cl < 1 || a.old_cl > a.C)) return false;
  if (kd_mode != KD_NONE && (a.Co < 1 || a.Co > a.C)) return false;
  if (a.B < 1 || a.B > 65535 || a.H < 1 || a.H > 65535 || a.h < 1 ||
      a.h > 65535 || a.w < 1 || a.W < 1)
    return false;
  return true;
}

}  // namespace

extern "C" int ucd_fused_loss_fwd(
    const void* z, const void* tz, const void* labels, int label_bytes,
    const void* iy0, const void* iy1, const void* fy, const void* ix0,
    const void* ix1, const void* fx, void* ce_part, void* kd_part, int B,
    int h, int w, int C, int Co, int H, int W, int old_cl, int ce_mode,
    int kd_mode, float alpha, void* stream) {
  const Args a = {(const float*)z,     (const float*)tz,
                  labels,              (const int32_t*)iy0,
                  (const int32_t*)iy1, (const float*)fy,
                  (const int32_t*)ix0, (const int32_t*)ix1,
                  (const float*)fx,    B,
                  h,                   w,
                  C,                   Co,
                  H,                   W,
                  old_cl,              alpha,
                  (cudaStream_t)stream};
  if (!args_ok(a, ce_mode, kd_mode, label_bytes))
    return (int)cudaErrorInvalidValue;
  if (label_bytes == 1) {
    DISPATCH_MODES(launch_fwd, uint8_t, a, (float*)ce_part, (float*)kd_part)
  } else {
    DISPATCH_MODES(launch_fwd, int32_t, a, (float*)ce_part, (float*)kd_part)
  }
  return (int)cudaGetLastError();
}

extern "C" int ucd_fused_loss_bwd(
    const void* z, const void* tz, const void* labels, int label_bytes,
    const void* iy0, const void* iy1, const void* fy, const void* ix0,
    const void* ix1, const void* fx, const void* ylo, const void* yhi,
    const void* xlo, const void* xhi, const void* coefs, void* dz, int B,
    int h, int w, int C, int Co, int H, int W, int old_cl, int ce_mode,
    int kd_mode, float alpha, void* stream) {
  const Args a = {(const float*)z,     (const float*)tz,
                  labels,              (const int32_t*)iy0,
                  (const int32_t*)iy1, (const float*)fy,
                  (const int32_t*)ix0, (const int32_t*)ix1,
                  (const float*)fx,    B,
                  h,                   w,
                  C,                   Co,
                  H,                   W,
                  old_cl,              alpha,
                  (cudaStream_t)stream};
  if (!args_ok(a, ce_mode, kd_mode, label_bytes))
    return (int)cudaErrorInvalidValue;
  if (label_bytes == 1) {
    DISPATCH_MODES(launch_bwd, uint8_t, a, (const int32_t*)ylo,
                   (const int32_t*)yhi, (const int32_t*)xlo,
                   (const int32_t*)xhi, (const float*)coefs, (float*)dz)
  } else {
    DISPATCH_MODES(launch_bwd, int32_t, a, (const int32_t*)ylo,
                   (const int32_t*)yhi, (const int32_t*)xlo,
                   (const int32_t*)xhi, (const float*)coefs, (float*)dz)
  }
  return (int)cudaGetLastError();
}
