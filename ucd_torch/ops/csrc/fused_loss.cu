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
// evaluates 51 exp and 4 log per output pixel (27.6 us at the special
// function units' 16 a clock per SM). A first design (one thread per pixel,
// two passes over the classes, each re-forming every upsampled logit from
// 4 gathered taps: 264 L1 loads a pixel) took 199 us. This one:
//  * Cells (the host's `cells`, as the backward): maximal rectangles of
//    output pixels whose taps read the same 2x2 source pixels, 16 x 16 at
//    scale 16. One warp per cell, 4 cells a block. The warp turns the
//    cell's 2x2 corners of each class into the bilinear polynomial
//    k0 + lx k1 + ly (k2 + lx k3) once (alpha folded into the old
//    logits'), kept in shared memory as one float4 a class.
//  * Each lane takes the cell's pixels 32 apart (labels read along the
//    cell's rows). Per pixel it forms the C + Co upsampled logits once, 3
//    FMAs each from a broadcast float4, into registers (template bounds NZ
//    >= C and NT >= Co, multiples of 8 up to 32 with NT = NZ or NZ - 8;
//    the values past C / Co are -inf and take no exp), then the maxima of
//    every log-sum-exp subset, then the sums, each exp one FMA and one ex2
//    of the special function unit. Other class counts (above 32, or Co far
//    below C) re-form the values from the float4s in each loop instead.
//  * Each lane adds its pixels' terms in order, the warp adds its lanes by
//    a fixed shuffle tree, the block its 4 warps in order: one partial a
//    block and term (2048 at the train shape), the same bits every run,
//    summed in float64 by the wrapper.
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

template <int KD>
__device__ __forceinline__ bool in_sub(int c, int Co) {
  return KD == KD_KD ? (c < Co) : (c == 0 || c >= Co);
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

constexpr int FWD_WARPS = 4;  // cells (warps) per block of the forward
constexpr float LOG2E = 1.4426950408889634f;

// exp(v - m) given m * log2(e): one FMA and one ex2 of the special function
// unit (relative error ~2^-22; -inf gives 0). The logs of the forward take
// __logf likewise: each is of a sum in [1, C], where its error is a few
// ulp, far inside the losses' tolerance.
__device__ __forceinline__ float exp_shift(float v, float m_log2e) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(v, LOG2E, -m_log2e)));
  return r;
}

// one class of a cell at pixel weights (lx, ly): the bilinear polynomial
// k.x + lx k.y + ly (k.z + lx k.w) of its 2x2 corners
__device__ __forceinline__ float bilin(float4 k, float lx, float ly) {
  return fmaf(ly, fmaf(lx, k.w, k.z), fmaf(lx, k.y, k.x));
}

// f(c) for the classes c in [lo, hi): unrolled over a register array of N
// in chunks of 8 (c known when compiled; a chunk wholly inside the range
// runs without a test per class) or, for N = 0, a loop
template <int N, typename F>
__device__ __forceinline__ void each(int lo, int hi, F f) {
  if constexpr (N > 0) {
#pragma unroll
    for (int c0 = 0; c0 < N; c0 += 8) {
      if (c0 >= hi) break;
      if (c0 + 8 <= lo) continue;
      if (c0 >= lo && c0 + 8 <= hi) {
#pragma unroll
        for (int k = 0; k < 8; ++k) f(c0 + k);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c0 + k >= lo && c0 + k < hi) f(c0 + k);
      }
    }
  } else {
    for (int c = lo; c < hi; ++c) f(c);
  }
}

// One output pixel's CE and KD terms from its cell's class polynomials zc
// (C) and tc (Co, alpha folded in). NZ >= C > NZ - 8 and NT >= Co > NT - 8
// hold the upsampled values in registers; NZ = NT = 0 re-forms them from
// the polynomials in each loop.
template <int KD, int NZ, int NT>
__device__ __forceinline__ void pixel_loss(const float4* zc, const float4* tc,
                                           int C, int Co, int old_cl,
                                           bool unce, int lab, float lx,
                                           float ly, float* ce, float* kd) {
  constexpr int RZ = NZ > 0 ? NZ : 1, RT = NT > 0 ? NT : 1;
  if constexpr (NZ > 0) __builtin_assume(C > NZ - 8);
  if constexpr (NT > 0) __builtin_assume(Co > NT - 8);
  float zv[RZ], tv[RT];
  if constexpr (NZ > 0) {
#pragma unroll
    for (int c = 0; c < NZ; ++c)
      zv[c] = c < C ? bilin(zc[c], lx, ly) : -INFINITY;
  }
  if constexpr (KD != KD_NONE && NT > 0) {
#pragma unroll
    for (int c = 0; c < NT; ++c)
      tv[c] = c < Co ? bilin(tc[c], lx, ly) : -INFINITY;
  }
  auto zval = [&](int c) {
    if constexpr (NZ > 0) return zv[c];
    else return bilin(zc[c], lx, ly);
  };
  auto tval = [&](int c) {
    if constexpr (NT > 0) return tv[c];
    else return bilin(tc[c], lx, ly);
  };
  // the values past C are -inf: the maxima may run over all NZ
  const int CZ = NZ > 0 ? NZ : C;

  float m_all = -INFINITY;
  each<NZ>(0, CZ, [&](int c) { m_all = fmaxf(m_all, zval(c)); });
  float s_all = 0.0f;
  const float mla = m_all * LOG2E;
  each<NZ>(0, C, [&](int c) { s_all += exp_shift(zval(c), mla); });
  const float den = m_all + __logf(s_all);

  const bool valid = lab != IGNORE;
  int safe = valid ? lab : 0;
  if (unce && safe < old_cl) safe = 0;
  safe = min(max(safe, 0), C - 1);
  if (valid) {
    float sel;
    if (unce && safe == 0) {  // lse over the old classes
      float m_old = -INFINITY, s_old = 0.0f;
      each<NZ>(0, old_cl, [&](int c) { m_old = fmaxf(m_old, zval(c)); });
      const float mlo = m_old * LOG2E;
      each<NZ>(0, old_cl, [&](int c) { s_old += exp_shift(zval(c), mlo); });
      sel = m_old + __logf(s_old);
    } else {
      sel = bilin(zc[safe], lx, ly);  // the same bits as zval(safe)
    }
    *ce = den - sel;
  } else {
    *ce = 0.0f;
  }
  if constexpr (KD == KD_NONE) {
    *kd = 0.0f;
  } else {
    // the KD subset of z: classes < Co (kd), {0} u classes >= Co (unkd)
    float m_sub = KD == KD_KD ? -INFINITY : zval(0);
    if constexpr (KD == KD_KD)
      each<NZ>(0, Co, [&](int c) { m_sub = fmaxf(m_sub, zval(c)); });
    else
      each<NZ>(Co, CZ, [&](int c) { m_sub = fmaxf(m_sub, zval(c)); });
    const float mls = m_sub * LOG2E;
    float s_sub = KD == KD_KD ? 0.0f : exp_shift(zval(0), mls);
    if constexpr (KD == KD_KD)
      each<NZ>(0, Co, [&](int c) { s_sub += exp_shift(zval(c), mls); });
    else
      each<NZ>(Co, C, [&](int c) { s_sub += exp_shift(zval(c), mls); });
    // softmax(alpha * tz): its sum, its class 0, the rest, and the sum of
    // its exps times z over c < Co (kd) or 1 <= c < Co (unkd)
    float m_t = -INFINITY;
    each<NT>(0, NT > 0 ? NT : Co, [&](int c) { m_t = fmaxf(m_t, tval(c)); });
    const float mlt = m_t * LOG2E;
    float s_t = 0.0f, e_t0 = 0.0f, s_mid = 0.0f, t2 = 0.0f;
    each<NT>(0, Co, [&](int c) {
      const float e = exp_shift(tval(c), mlt);
      s_t += e;
      if (c == 0) {
        e_t0 = e;
        if (KD == KD_KD) t2 += e * zval(c);
      } else {
        s_mid += e;
        t2 += e * zval(c);
      }
    });
    const float lse_sub = m_sub + __logf(s_sub);
    const float inv = __frcp_rn(s_t);
    *kd = KD == KD_KD ? t2 * inv - lse_sub
                      : e_t0 * inv * (lse_sub - den) + t2 * inv -
                            s_mid * inv * den;
  }
}

// One warp per cell (b, cy, cx), FWD_WARPS a block; ycells / xcells: (first
// output, end, source of tap 0, of tap 1) per cell. Writes one partial sum
// of each term per block.
// up to 40 register values (the main path's 24 + 16): 5 blocks an SM (at
// 6, 80 registers, the main path's kernel spilled)
template <int KD, int NZ, int NT>
__global__ void __launch_bounds__(FWD_WARPS * 32, NZ + NT <= 40 ? 5 : 1)
    fused_loss_fwd_kernel(const float* __restrict__ z,
                          const float* __restrict__ tz,
                          const void* __restrict__ labels, int label_bytes,
                          const float* __restrict__ fy,
                          const float* __restrict__ fx,
                          const int4* __restrict__ ycells,
                          const int4* __restrict__ xcells,
                          float* __restrict__ ce_part,
                          float* __restrict__ kd_part, int n_cells, int h,
                          int w, int C, int Co, int H, int W, int old_cl,
                          int unce, float alpha, int ncy, int ncx) {
  extern __shared__ float4 poly[];
  __shared__ float sums[2][FWD_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x * FWD_WARPS + warp;
  float ce = 0.0f, kd = 0.0f;
  if (cell < n_cells) {  // the whole warp
    float4* zc = poly + warp * (C + Co);
    float4* tc = zc + C;
    const int b = cell / (ncy * ncx);
    const int4 yc = ycells[(cell / ncx) % ncy], xc = xcells[cell % ncx];
    const int64_t r0 = (int64_t)b * h + yc.z, r1 = (int64_t)b * h + yc.w;
    const int64_t p00 = r0 * w + xc.z, p01 = r0 * w + xc.w;
    const int64_t p10 = r1 * w + xc.z, p11 = r1 * w + xc.w;
    for (int c = lane; c < C; c += 32) {
      const float a = __ldg(z + p00 * C + c), bb = __ldg(z + p01 * C + c);
      const float cc = __ldg(z + p10 * C + c), d = __ldg(z + p11 * C + c);
      zc[c] = make_float4(a, bb - a, cc - a, (a - bb) - (cc - d));
    }
    if (KD != KD_NONE)
      for (int c = lane; c < Co; c += 32) {
        const float a = alpha * __ldg(tz + p00 * Co + c);
        const float bb = alpha * __ldg(tz + p01 * Co + c);
        const float cc = alpha * __ldg(tz + p10 * Co + c);
        const float d = alpha * __ldg(tz + p11 * Co + c);
        tc[c] = make_float4(a, bb - a, cc - a, (a - bb) - (cc - d));
      }
    __syncwarp();
    const int nx = xc.y - xc.x, n = (yc.y - yc.x) * nx;
    for (int p = lane; p < n; p += 32) {
      const int y = yc.x + p / nx, x = xc.x + p % nx;
      const int64_t i = ((int64_t)b * H + y) * W + x;
      const int lab = label_bytes == 1 ? (int)((const uint8_t*)labels)[i]
                                       : ((const int32_t*)labels)[i];
      float ce_px, kd_px;
      pixel_loss<KD, NZ, NT>(zc, tc, C, Co, old_cl, unce != 0, lab, fx[x],
                             fy[y], &ce_px, &kd_px);
      ce += ce_px;
      kd += kd_px;
    }
  }
  ce = warp_sum(ce);
  kd = warp_sum(kd);
  if (lane == 0) {
    sums[0][warp] = ce;
    sums[1][warp] = kd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, k = 0.0f;
    for (int i = 0; i < FWD_WARPS; ++i) {
      a += sums[0][i];
      k += sums[1][i];
    }
    ce_part[blockIdx.x] = a;
    kd_part[blockIdx.x] = k;
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
  int label_bytes;
  const int32_t *iy0, *iy1;
  const float* fy;
  const int32_t *ix0, *ix1;
  const float* fx;
  int B, h, w, C, Co, H, W, old_cl;
  float alpha;
  cudaStream_t stream;
};

struct Cells {
  const int4 *ycells, *xcells;
  const int32_t *yfeeds, *xfeeds;
  int ncy, ncx;
};

template <int KD, int NZ, int NT>
cudaError_t launch_fwd_n(const Args& a, const Cells& cl, bool unce,
                         float* ce_part, float* kd_part) {
  const int n_cells = a.B * cl.ncy * cl.ncx;
  const int64_t smem = FWD_WARPS * (int64_t)(a.C + a.Co) * sizeof(float4);
  if (smem > MAX_SHARED) return cudaErrorInvalidValue;
  auto kernel = fused_loss_fwd_kernel<KD, NZ, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(n_cells + FWD_WARPS - 1) / FWD_WARPS, FWD_WARPS * 32, (int)smem,
           a.stream>>>(a.z, a.tz, a.labels, a.label_bytes, a.fy, a.fx,
                       cl.ycells, cl.xcells, ce_part, kd_part, n_cells, a.h,
                       a.w, a.C, a.Co, a.H, a.W, a.old_cl, unce ? 1 : 0,
                       a.alpha, cl.ncy, cl.ncx);
  return cudaGetLastError();
}

// the register bounds for (C, Co): multiples of 8 with C > NZ - 8 and Co >
// NT - 8, NT in {NZ, NZ - 8}; (0, 0) (the loop version) otherwise
template <int KD>
cudaError_t launch_fwd(const Args& a, const Cells& cl, bool unce,
                       float* ce_part, float* kd_part) {
  const int nz = a.C <= 32 ? (a.C + 7) / 8 : 0;
  int nt = KD == KD_NONE ? 1 : (a.Co + 7) / 8;
  if (nz == 0 || (KD != KD_NONE && (nt > nz || nt < nz - 1))) nt = 0;
  const auto go = [&](auto f) { return f(a, cl, unce, ce_part, kd_part); };
  if constexpr (KD == KD_NONE) {
    switch (nt == 0 ? 0 : nz) {
      case 1: return go(launch_fwd_n<KD, 8, 8>);
      case 2: return go(launch_fwd_n<KD, 16, 8>);
      case 3: return go(launch_fwd_n<KD, 24, 8>);
      case 4: return go(launch_fwd_n<KD, 32, 8>);
      default: return go(launch_fwd_n<KD, 0, 0>);
    }
  } else {
    switch (nt == 0 ? 0 : nz * 8 + nt) {
      case 9: return go(launch_fwd_n<KD, 8, 8>);
      case 17: return go(launch_fwd_n<KD, 16, 8>);
      case 18: return go(launch_fwd_n<KD, 16, 16>);
      case 26: return go(launch_fwd_n<KD, 24, 16>);
      case 27: return go(launch_fwd_n<KD, 24, 24>);
      case 35: return go(launch_fwd_n<KD, 32, 24>);
      case 36: return go(launch_fwd_n<KD, 32, 32>);
      default: return go(launch_fwd_n<KD, 0, 0>);
    }
  }
}

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

// ycells / xcells (ncy, 4) / (ncx, 4) int32: the host's cell tables
// (ops/fused_eval.py `cells`); ce_part / kd_part: float32 of
// ceil(B * ncy * ncx / FWD_WARPS), one partial sum per block.
extern "C" int ucd_fused_loss_fwd(
    const void* z, const void* tz, const void* labels, int label_bytes,
    const void* iy0, const void* iy1, const void* fy, const void* ix0,
    const void* ix1, const void* fx, const void* ycells, const void* xcells,
    void* ce_part, void* kd_part, int B, int h, int w, int C, int Co, int H,
    int W, int old_cl, int ce_mode, int kd_mode, int ncy, int ncx,
    float alpha, void* stream) {
  const Args a = {(const float*)z,     (const float*)tz,
                  labels,              label_bytes,
                  (const int32_t*)iy0,
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
  const Cells cl = {(const int4*)ycells, (const int4*)xcells, nullptr,
                    nullptr, ncy, ncx};
  const bool unce = ce_mode == CE_UNCE;
  float *ce = (float*)ce_part, *kd = (float*)kd_part;
  switch (kd_mode) {
    case KD_NONE: return (int)launch_fwd<KD_NONE>(a, cl, unce, ce, kd);
    case KD_KD: return (int)launch_fwd<KD_KD>(a, cl, unce, ce, kd);
    default: return (int)launch_fwd<KD_UNKD>(a, cl, unce, ce, kd);
  }
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
                  labels,              label_bytes,
                  (const int32_t*)iy0,
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
