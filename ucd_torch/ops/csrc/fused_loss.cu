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
// Backward (`fused_loss_bwd_cells_kernel`, then `fused_loss_fold_kernel`).
// Bound: operations, the forward's exps at the special function units' rate
// (the gradient terms are the sums' exps times the subsets' reciprocals).
// This design spends more: per output pixel the softmax terms once, then
// ~3 exp per class again for the gradient rather than keep 32 pixels' exps,
// and 4 fused multiply-adds per class to fold it.
// The gradient goes to the low-res logits, so many output pixels add into
// one source pixel; the fold must stay deterministic without float atomics
// and must not recompute a pixel once per source pixel it taps.
//  * Cells. The host cuts the output into cells: maximal rectangles of
//    pixels whose four taps read the same 2x2 source pixels (16 x 16 pixels
//    at scale 16, other sizes at the clamped edges and at non-integer
//    ratios), from the same tap tables as the forward.
//  * One warp per cell. It copies the cell's 2x2 source pixels of z and tz
//    into shared memory once. In batches of 32 pixels, each lane computes
//    one pixel's softmax terms (maxima and sums of every log-sum-exp
//    subset, two passes over the classes, all lanes reading the same class
//    at once: broadcasts) and leaves them in shared memory; then each lane
//    takes one class (classes beyond 32 in further rounds) and walks the
//    batch's pixels in order, forming the analytic gradient of the pixel
//    and class once and adding it, times the pixel's bilinear weight wy*wx,
//    onto the cell's 4 corners. A lane's 4 corner sums of its class live in
//    registers during a batch and in shared memory between batches: no
//    array indexed at run time, no reduction across lanes.
//  * Each cell writes its (2, 2, C) partial sums. The fold kernel adds, for
//    each low-res (pixel, class), the <= 3 x 3 corners that land on it,
//    both corners of a clamped edge included, in the fixed order of the
//    host's feed tables. Two launches, the same bits every run.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an argument the kernels do not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { CE_PLAIN = 0, CE_UNCE = 1 };
enum { KD_NONE = 0, KD_KD = 1, KD_UNKD = 2 };
constexpr int IGNORE = 255;
constexpr int FWD_THREADS = 128;

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

constexpr int CELL_WARPS = 4;  // cells (warps) per block of the backward
constexpr int BATCH_PX = 32;   // pixels whose terms a warp holds at once
constexpr int NSTAT = 16;      // floats of one pixel's terms
// sm_90's opt-in dynamic shared memory per block: the backward's only limit
// on the class count (each warp holds its cell's corners and sums)
constexpr int64_t MAX_SHARED = 227 * 1024;

// One pixel's terms as the gradient walk reads them (shared memory, 16
// floats, read as four float4 broadcasts).
enum {
  T_HY, T_LY, T_HX, T_LX,       // bilinear weights
  T_M_ALL, T_INV_ALL,           // max and 1 / sum of exp over all classes
  T_W_CE, T_SAFE,               // CE scale (0 for label 255); label' bits
  T_M_OLD, T_INV_OLD,           // classes < old_cl (unce)
  T_M_SUB, T_INV_SUB,           // the KD subset of z
  T_M_T, T_INV_T,               // alpha * tz over its Co classes
  T_LAM0, T_UNUSED              // softmax(alpha * tz)_0
};

// z at (pixel weights, class c) from the cell's 2x2 source values of
// class c: the same arithmetic as `up`, so both walks see the same bits
__device__ __forceinline__ float lerp4(const float* v, int C, int c, float hy,
                                       float ly, float hx, float lx) {
  return hy * (hx * v[c] + lx * v[C + c]) +
         ly * (hx * v[2 * C + c] + lx * v[3 * C + c]);
}

// The softmax terms of one output pixel into `out` (NSTAT floats).
template <int CE, int KD>
__device__ __forceinline__ void pixel_terms(const float* zs, const float* ts,
                                            int C, int Co, int old_cl,
                                            float alpha, int safe, float w_ce,
                                            float hy, float ly, float hx,
                                            float lx, float* out) {
  float m_all = -INFINITY, m_old = -INFINITY, m_sub = -INFINITY,
        m_t = -INFINITY;
  for (int c = 0; c < C; ++c) {
    const float v = lerp4(zs, C, c, hy, ly, hx, lx);
    m_all = fmaxf(m_all, v);
    if (CE == CE_UNCE && c < old_cl) m_old = fmaxf(m_old, v);
    if (KD != KD_NONE && in_sub<KD>(c, Co)) m_sub = fmaxf(m_sub, v);
  }
  if (KD != KD_NONE)
    for (int c = 0; c < Co; ++c)
      m_t = fmaxf(m_t, alpha * lerp4(ts, Co, c, hy, ly, hx, lx));
  float s_all = 0.0f, s_old = 0.0f, s_sub = 0.0f, s_t = 0.0f, e_t0 = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float v = lerp4(zs, C, c, hy, ly, hx, lx);
    s_all += expf(v - m_all);
    if (CE == CE_UNCE && c < old_cl) s_old += expf(v - m_old);
    if (KD != KD_NONE && in_sub<KD>(c, Co)) s_sub += expf(v - m_sub);
  }
  if (KD != KD_NONE)
    for (int c = 0; c < Co; ++c) {
      const float e = expf(alpha * lerp4(ts, Co, c, hy, ly, hx, lx) - m_t);
      s_t += e;
      if (c == 0) e_t0 = e;
    }
  const float inv_t = KD != KD_NONE ? 1.0f / s_t : 0.0f;
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(hy, ly, hx, lx);
  o[1] = make_float4(m_all, 1.0f / s_all, w_ce, __int_as_float(safe));
  o[2] = make_float4(m_old, CE == CE_UNCE ? 1.0f / s_old : 0.0f, m_sub,
                     KD != KD_NONE ? 1.0f / s_sub : 0.0f);
  o[3] = make_float4(m_t, inv_t, e_t0 * inv_t, 0.0f);
}

// The backward's first kernel: one warp per cell (b, cy, cx) writes the
// cell's gradient folded onto its 2x2 source pixels, part[cell][2r+s][c].
// ycells / xcells: (first output, end, source of tap 0, of tap 1) per cell.
template <int CE, int KD, typename L>
__global__ void __launch_bounds__(CELL_WARPS * 32)
    fused_loss_bwd_cells_kernel(const float* __restrict__ z,
                                const float* __restrict__ tz,
                                const L* __restrict__ labels,
                                const float* __restrict__ fy,
                                const float* __restrict__ fx,
                                const int4* __restrict__ ycells,
                                const int4* __restrict__ xcells,
                                const float* __restrict__ coefs,
                                float* __restrict__ part, int n_cells, int h,
                                int w, int C, int Co, int H, int W, int old_cl,
                                float alpha, int ncy, int ncx) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x * CELL_WARPS + warp;
  if (cell >= n_cells) return;  // the whole warp; nothing below syncs blocks
  // this warp's shared memory: [z corners][tz corners][sums][pixel terms]
  float* zs = smem + (int64_t)warp * (8 * C + 4 * Co + BATCH_PX * NSTAT);
  float* ts = zs + 4 * C;
  float* acc = ts + 4 * Co;
  float* terms = acc + 4 * C;
  const int b = cell / (ncy * ncx);
  const int4 yc = ycells[(cell / ncx) % ncy], xc = xcells[cell % ncx];
  // corner k = 2 r + s is source pixel (tap r of the rows, tap s of the
  // columns): (yc.z | yc.w, xc.z | xc.w)
  for (int i = lane; i < 4 * C; i += 32) {
    const int k = i / C, c = i - k * C;
    const int row = k & 2 ? yc.w : yc.z, col = k & 1 ? xc.w : xc.z;
    zs[i] = __ldg(z + (((int64_t)b * h + row) * w + col) * C + c);
    acc[i] = 0.0f;
  }
  if (KD != KD_NONE)
    for (int i = lane; i < 4 * Co; i += 32) {
      const int k = i / Co, c = i - k * Co;
      const int row = k & 2 ? yc.w : yc.z, col = k & 1 ? xc.w : xc.z;
      ts[i] = __ldg(tz + (((int64_t)b * h + row) * w + col) * Co + c);
    }
  __syncwarp();
  const float coef_ce = coefs[0], coef_kd = coefs[1];
  const int nx = xc.y - xc.x, n = (yc.y - yc.x) * nx;

  for (int p0 = 0; p0 < n; p0 += BATCH_PX) {
    // (a) lane i: the terms of pixel p0 + i
    const int p = p0 + lane;
    if (p < n) {
      const int y = yc.x + p / nx, x = xc.x + p % nx;
      const float ly = fy[y], lx = fx[x];
      bool valid;
      const int safe = safe_label<CE>(
          (int)labels[((int64_t)b * H + y) * W + x], old_cl, C, &valid);
      pixel_terms<CE, KD>(zs, ts, C, Co, old_cl, alpha, safe,
                          valid ? coef_ce : 0.0f, 1.0f - ly, ly, 1.0f - lx,
                          lx, terms + lane * NSTAT);
    }
    __syncwarp();
    // (b) lane i: class c0 + i over the batch's pixels, in order
    const int np = min(BATCH_PX, n - p0);
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < C, on_t = KD != KD_NONE && c < Co;
      float zv[4], tv[4], a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        zv[k] = on ? zs[k * C + c] : 0.0f;
        tv[k] = on_t ? ts[k * Co + c] : 0.0f;
        a[k] = on ? acc[k * C + c] : 0.0f;
      }
#pragma unroll 2
      for (int i = 0; i < np; ++i) {
        const float4* tp = reinterpret_cast<const float4*>(terms + i * NSTAT);
        const float4 wts = tp[0], t1 = tp[1], t2 = tp[2], t3 = tp[3];
        const float hy = wts.x, ly = wts.y, hx = wts.z, lx = wts.w;
        const float v =
            hy * (hx * zv[0] + lx * zv[1]) + ly * (hx * zv[2] + lx * zv[3]);
        const float pc = expf(v - t1.x) * t1.y;  // softmax(z)_c
        const int safe = __float_as_int(t1.w);
        float d_sel;
        if (CE == CE_UNCE && safe == 0)  // the same for the whole warp
          d_sel = c < old_cl ? expf(v - t2.x) * t2.y : 0.0f;
        else
          d_sel = c == safe ? 1.0f : 0.0f;
        float g = t1.z * (pc - d_sel);
        if (KD != KD_NONE) {
          const float sub = in_sub<KD>(c, Co) ? expf(v - t2.z) * t2.w : 0.0f;
          const float u =
              hy * (hx * tv[0] + lx * tv[1]) + ly * (hx * tv[2] + lx * tv[3]);
          const float lam = c < Co ? expf(alpha * u - t3.x) * t3.y : 0.0f;
          const float g_kd = KD == KD_UNKD
                                 ? t3.z * sub + (c >= 1 ? lam : 0.0f) - pc
                                 : lam - sub;
          g += coef_kd * g_kd;
        }
        a[0] += hy * hx * g;
        a[1] += hy * lx * g;
        a[2] += ly * hx * g;
        a[3] += ly * lx * g;
      }
      if (on)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k * C + c] = a[k];
    }
    __syncwarp();  // the terms are used up; the sums are in place
  }
  float* out = part + (int64_t)cell * 4 * C;
  for (int i = lane; i < 4 * C; i += 32) out[i] = acc[i];
}

// The backward's second kernel: one thread per low-res (b, i, j, c) adds
// the corners of the cells that land on it, rows' feeds outer, columns'
// inner, each in increasing order; feeds are 2 * cell + tap, -1 for none.
__global__ void __launch_bounds__(256)
    fused_loss_fold_kernel(const float* __restrict__ part,
                           const int32_t* __restrict__ yfeeds,
                           const int32_t* __restrict__ xfeeds,
                           float* __restrict__ dz, int64_t total, int h, int w,
                           int C, int ncy, int ncx) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  int64_t rest = idx / C;
  const int j = (int)(rest % w);
  rest /= w;
  const int i = (int)(rest % h);
  const int64_t b = rest / h;
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int fy_ = yfeeds[i * 3 + e];
    if (fy_ < 0) continue;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int fx_ = xfeeds[j * 3 + f];
      if (fx_ < 0) continue;
      const int64_t cell = (b * ncy + (fy_ >> 1)) * ncx + (fx_ >> 1);
      sum += part[(cell * 4 + (fy_ & 1) * 2 + (fx_ & 1)) * C + c];
    }
  }
  dz[idx] = sum;
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

struct Cells {
  const int4 *ycells, *xcells;
  const int32_t *yfeeds, *xfeeds;
  int ncy, ncx;
};

template <int CE, int KD, typename L>
void launch_bwd(const Args& a, const Cells& cl, const float* coefs,
                float* part, float* dz, int* err) {
  const int n_cells = a.B * cl.ncy * cl.ncx;
  const int64_t smem_bytes = CELL_WARPS *
                             (8 * (int64_t)a.C + 4 * a.Co + BATCH_PX * NSTAT) *
                             sizeof(float);
  if (smem_bytes > MAX_SHARED) {
    *err = (int)cudaErrorInvalidValue;
    return;
  }
  const int smem = (int)smem_bytes;
  auto kernel = fused_loss_bwd_cells_kernel<CE, KD, L>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      *err = (int)e;
      return;
    }
  }
  kernel<<<(n_cells + CELL_WARPS - 1) / CELL_WARPS, CELL_WARPS * 32, smem,
           a.stream>>>(a.z, a.tz, (const L*)a.labels, a.fy, a.fx, cl.ycells,
                       cl.xcells, coefs, part, n_cells, a.h, a.w, a.C, a.Co,
                       a.H, a.W, a.old_cl, a.alpha, cl.ncy, cl.ncx);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    *err = (int)e;
    return;
  }
  const int64_t total = (int64_t)a.B * a.h * a.w * a.C;
  fused_loss_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                           a.stream>>>(part, cl.yfeeds, cl.xfeeds, dz, total,
                                       a.h, a.w, a.C, cl.ncy, cl.ncx);
  *err = (int)cudaGetLastError();
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
  if (a.C < 1) return false;
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

// ycells / xcells (ncy, 4) / (ncx, 4) int32 and yfeeds / xfeeds (h, 3) /
// (w, 3) int32: the host's cell tables (ops/fused_loss.py `cells`); part:
// float32 scratch of B * ncy * ncx * 4 * C; dz (B, h, w, C) float32.
extern "C" int ucd_fused_loss_bwd(
    const void* z, const void* tz, const void* labels, int label_bytes,
    const void* iy0, const void* iy1, const void* fy, const void* ix0,
    const void* ix1, const void* fx, const void* ycells, const void* yfeeds,
    const void* xcells, const void* xfeeds, const void* coefs, void* part,
    void* dz, int B, int h, int w, int C, int Co, int H, int W, int old_cl,
    int ce_mode, int kd_mode, int ncy, int ncx, float alpha, void* stream) {
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
  if (!args_ok(a, ce_mode, kd_mode, label_bytes) || ncy < 1 || ncx < 1 ||
      (int64_t)B * ncy * ncx > ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  const Cells cl = {(const int4*)ycells,    (const int4*)xcells,
                    (const int32_t*)yfeeds, (const int32_t*)xfeeds,
                    ncy,                    ncx};
  int err = 0;
  if (label_bytes == 1) {
    DISPATCH_MODES(launch_bwd, uint8_t, a, cl, (const float*)coefs,
                   (float*)part, (float*)dz, &err)
  } else {
    DISPATCH_MODES(launch_bwd, int32_t, a, cl, (const float*)coefs,
                   (float*)part, (float*)dz, &err)
  }
  return err;
}
