// Fused BatchNorm + activation (the ABN chain) on bf16 activations, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses BatchNorm + leaky-ReLU
// into the convolutions' fusions, so the JAX package has no Pallas kernel
// here. On the card the plain chain (models/layers.py `ABN`) widens each
// bf16 conv output to f32, runs cuDNN's f32 BatchNorm and an f32
// leaky-ReLU, and casts back, with two more casts in the backward: about
// 104 bytes moved per element and step (train forward 32, the donor's eval
// forward 28, backward 44), and two f32 tensors per element kept for the
// backward. That made it the largest cost of the train step.
//
// Bound. The chain is pure data movement: a few operations per element
// against 2 bytes of bf16, far below the card's 295 operations a byte, so
// its bound is bytes at 3.35 TB/s: reading every input once and writing
// every output once, 4 bytes per element for a forward (x in, y out) and 6
// for the backward (x and dy in, dx out).
//
// Design. x is the row-major [R, C] matrix of a channels_last activation
// (R = batch * H * W). Each thread owns 8 channels (one 16-byte load of 8
// bf16), widens exactly to f32, and keeps f32 in registers only; every
// output is rounded once to bf16. The computation is the plain chain's:
//   z = (x - mean) * (invstd * w) + b   in f32 (one device function),
//   y = z > 0 ? z : z * slope           (identity: slope 1),
// the variance the biased, cancellation-free one (two passes over each
// thread's group of rows in registers, Chan's formula between groups and
// partials; never E[x^2] - E[x]^2).
//  * Train forward: a statistics kernel (a block per chunk of rows and
//    slice of channels; per-block (mean, M2) partials in scratch), a
//    finalize kernel (fixed-order combine of the partials: mean, invstd,
//    and the running mean and *biased* variance lerped with the momentum
//    unless `update` is 0), then the normalize + activate kernel, whose
//    second read of x comes from the 50 MB L2 for a tensor that fits: 6
//    bytes moved per element.
//  * Eval forward (the frozen donor, a serving model): one elementwise
//    pass with scale and shift from the running statistics: 4 bytes.
//  * Backward: a reduction kernel (the two per-channel sums of dz and of
//    dz * (x - mean), z recomputed with the forward's formula so that the
//    activation's mask is the forward's), a finalize kernel (dW and dB in
//    f32, and the coefficients of dx), then the dx kernel: 10 bytes.
// Only x (bf16) and the per-channel mean and invstd are kept for the
// backward. Every reduction runs in a fixed order with no atomics, so a
// result is bit-reproducible from run to run.
//
// C interface (ctypes): each entry point launches its kernels on `stream`
// and returns cudaGetLastError() after them, or cudaErrorInvalidValue for
// a plan the kernels do not take. The host computes the plan
// (ops/fused_abn.py `launch_plan`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;           // rows a thread has in flight
constexpr int BLOCKS_PER_SM = 2;    // the host's plan: 2 blocks an SM
constexpr int FIN_CH = THREADS / 32;  // channels of a finalize block: a
                                      // warp each
constexpr int MAX_ROW_BLOCKS = 65535;

typedef __nv_bfloat16 bf16;

// VEC bf16 values as one load (16 bytes for 8), kept packed in registers
// until used: half the registers of widened values
template <int VEC>
using Raw = typename std::conditional<VEC == 8, uint4, unsigned short>::type;

template <int VEC>
__device__ __forceinline__ Raw<VEC> load(const bf16* p) {
  return *reinterpret_cast<const Raw<VEC>*>(p);
}

// value i of a load, widened exactly to f32 (i a constant after unrolling)
template <int VEC>
__device__ __forceinline__ float widen(const Raw<VEC>& r, int i) {
  if constexpr (VEC == 8) {
    const unsigned w = (i >> 1) == 0   ? r.x
                       : (i >> 1) == 1 ? r.y
                       : (i >> 1) == 2 ? r.z
                                       : r.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float((unsigned)r << 16);
  }
}

template <int VEC>
__device__ __forceinline__ void store(bf16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// the normalized value, the same function in every kernel, so that the
// backward's mask is the forward's sign
__device__ __forceinline__ float norm(float x, float mean, float scale,
                                      float shift) {
  return fmaf(x - mean, scale, shift);
}

__device__ __forceinline__ float act(float z, float slope) {
  return z > 0.f ? z : z * slope;
}

__device__ __forceinline__ float act_grad(float z, float g, float slope) {
  return z > 0.f ? g : g * slope;
}

// torch's lerp (ATen's Lerp.h): self + w (end - self) for |w| < 0.5
__device__ __forceinline__ float lerp(float self, float end, float w) {
  return fabsf(w) < 0.5f ? self + w * (end - self)
                         : end - (end - self) * (1.f - w);
}

// Chan's combine of (n, mean, M2) with a partner's (n_b, mean_b, M2_b):
// the weights depend on the counts alone, so a thread computes them once
// for all its channels. Either count may be 0 (its mean and M2 are 0).
struct Weights {
  float fb, cross;  // n_b / (n + n_b), n n_b / (n + n_b)
};

__device__ __forceinline__ Weights chan_weights(float n, float n_b) {
  const float tot = n + n_b;
  const float fb = tot > 0.f ? n_b / tot : 0.f;
  return {fb, n * fb};
}

__device__ __forceinline__ void chan(float& mean, float& m2, float mean_b,
                                     float m2_b, Weights w) {
  const float d = mean_b - mean;
  mean = fmaf(d, w.fb, mean);
  m2 = m2 + m2_b + d * d * w.cross;
}

// The thread's place in a [R, C] block: tx threads along channel groups
// of VEC, THREADS / tx along rows; block (slice, row chunk).
struct Place {
  int gx, ty, nty, c0;
  int64_t r_begin, r_end;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Place place(int64_t R, int C, int tx,
                                       int64_t rb_rows) {
  Place p;
  p.gx = threadIdx.x % tx;
  p.ty = threadIdx.x / tx;
  p.nty = THREADS / tx;
  p.c0 = (blockIdx.x * tx + p.gx) * VEC;
  p.active = p.c0 < C;
  p.r_begin = (int64_t)blockIdx.y * rb_rows;
  p.r_end = p.r_begin + rb_rows < R ? p.r_begin + rb_rows : R;
  return p;
}

// a block's shared slot of (channel i of the thread's group, row ty):
// neighbouring threads of a row on neighbouring banks
__device__ __forceinline__ int slot(const Place& p, int tx, int i, int ty) {
  return (i * p.nty + ty) * tx + p.gx;
}

// statistics: per (row chunk, channel) the chunk's mean and M2
template <int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    abn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part,
                     int64_t R, int C, int tx, int64_t rb_rows) {
  __shared__ float s_mean[THREADS * VEC], s_m2[THREADS * VEC];
  __shared__ float s_n[THREADS];
  const Place p = place<VEC>(R, C, tx, rb_rows);
  float mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  float n = 0.f;
  if (p.active) {
    for (int64_t r0 = p.r_begin + p.ty; r0 < p.r_end;
         r0 += (int64_t)p.nty * UNROLL) {
      Raw<VEC> v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t r = r0 + (int64_t)u * p.nty;
        if (r < p.r_end) v[u] = load<VEC>(x + r * C + p.c0);
      }
      // the group's own mean and M2 (two passes over registers), then
      // Chan's combine into the thread's
      const int64_t left = (p.r_end - r0 + p.nty - 1) / p.nty;
      const int k = left < UNROLL ? (int)left : UNROLL;
      const float inv_k = 1.f / (float)k;
      const Weights wg = chan_weights(n, (float)k);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (u < k) sum += widen<VEC>(v[u], i);
        const float gm = sum * inv_k;
        float gm2 = 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (u < k) {
            const float d = widen<VEC>(v[u], i) - gm;
            gm2 = fmaf(d, d, gm2);
          }
        }
        chan(mean[i], m2[i], gm, gm2, wg);
      }
      n += (float)k;
    }
  }
  // tree over the rows of the block, in a fixed order: row ty takes row
  // ty + s (the rows read and the rows written at one level are disjoint)
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[slot(p, tx, i, p.ty)] = mean[i];
    s_m2[slot(p, tx, i, p.ty)] = m2[i];
  }
  if (p.gx == 0) s_n[p.ty] = n;
  __syncthreads();
  for (int s = p.nty / 2; s > 0; s /= 2) {
    if (p.ty < s) {
      const float nb = s_n[p.ty + s];
      const Weights wb = chan_weights(n, nb);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        chan(mean[i], m2[i], s_mean[slot(p, tx, i, p.ty + s)],
             s_m2[slot(p, tx, i, p.ty + s)], wb);
        s_mean[slot(p, tx, i, p.ty)] = mean[i];
        s_m2[slot(p, tx, i, p.ty)] = m2[i];
      }
      n += nb;
      if (p.gx == 0) s_n[p.ty] = n;
    }
    __syncthreads();
  }
  if (p.ty == 0 && p.active) {
    float* pm = part + (int64_t)blockIdx.y * C;
    float* pv = part + (int64_t)(gridDim.y + blockIdx.y) * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (p.c0 + i < C) {
        pm[p.c0 + i] = mean[i];
        pv[p.c0 + i] = m2[i];
      }
    }
  }
}

// the partials of chunks lane, lane + 32, ... of one channel (a warp a
// channel), then a fixed tree over the lanes; (mean, M2) land in lane 0
__device__ __forceinline__ void combine_partials(
    const float* part, int64_t R, int C, int n_rb, int64_t rb_rows, int c,
    float& mean, float& m2) {
  const int lane = threadIdx.x % 32;
  mean = m2 = 0.f;
  float n = 0.f;
  if (c < C) {
    for (int rb = lane; rb < n_rb; rb += 32) {
      const int64_t left = R - (int64_t)rb * rb_rows;
      const float nb = (float)(left < rb_rows ? left : rb_rows);
      chan(mean, m2, part[(int64_t)rb * C + c],
           part[(int64_t)(n_rb + rb) * C + c], chan_weights(n, nb));
      n += nb;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s /= 2) {
    const float mb = __shfl_down_sync(0xffffffffu, mean, s);
    const float vb = __shfl_down_sync(0xffffffffu, m2, s);
    const float nb = __shfl_down_sync(0xffffffffu, n, s);
    chan(mean, m2, mb, vb, chan_weights(n, nb));
    n += nb;
  }
}

// stats = [mean; invstd] (2, C); the running statistics move if `update`
__global__ void __launch_bounds__(THREADS)
    abn_stats_finalize_kernel(const float* __restrict__ part,
                              float* __restrict__ stats,
                              float* __restrict__ running_mean,
                              float* __restrict__ running_var, int64_t R,
                              int C, int n_rb, int64_t rb_rows, float eps,
                              float momentum, int update) {
  const int c = blockIdx.x * FIN_CH + threadIdx.x / 32;
  float mean, m2;
  combine_partials(part, R, C, n_rb, rb_rows, c, mean, m2);
  if (threadIdx.x % 32 == 0 && c < C) {
    const float var = m2 / (float)R;
    stats[c] = mean;
    stats[C + c] = 1.f / sqrtf(var + eps);
    if (update) {
      running_mean[c] = lerp(running_mean[c], mean, momentum);
      running_var[c] = lerp(running_var[c], var, momentum);
    }
  }
}

// y = act(norm(x)): train mode from stats = [mean; invstd], eval mode from
// the running statistics (mean_or_rm, invstd_or_rv), whose mean and invstd
// it also writes to `saved` (2, C)
template <int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    abn_apply_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                     const float* __restrict__ mean_or_rm,
                     const float* __restrict__ invstd_or_rv,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, float* __restrict__ saved,
                     int64_t R, int C, int tx, int64_t rb_rows, float eps,
                     float slope, int eval) {
  const Place p = place<VEC>(R, C, tx, rb_rows);
  if (!p.active) return;
  float mean[VEC], scale[VEC], shift[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = p.c0 + i < C ? p.c0 + i : C - 1;
    const float inv =
        eval ? 1.f / sqrtf(invstd_or_rv[c] + eps) : invstd_or_rv[c];
    mean[i] = mean_or_rm[c];
    scale[i] = inv * weight[c];
    shift[i] = bias[c];
    if (eval && blockIdx.y == 0 && p.ty == 0 && p.c0 + i < C) {
      saved[c] = mean[i];
      saved[C + c] = inv;
    }
  }
  for (int64_t r0 = p.r_begin + p.ty; r0 < p.r_end;
       r0 += (int64_t)p.nty * UNROLL) {
    Raw<VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t r = r0 + (int64_t)u * p.nty;
      if (r < p.r_end) v[u] = load<VEC>(x + r * C + p.c0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t r = r0 + (int64_t)u * p.nty;
      if (r < p.r_end) {
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          out[i] = act(norm(widen<VEC>(v[u], i), mean[i], scale[i], shift[i]),
                       slope);
        store<VEC>(y + r * C + p.c0, out);
      }
    }
  }
}

// the per-thread constants of the backward kernels
template <int VEC>
__device__ __forceinline__ void bwd_params(
    const float* stats, const float* weight, const float* bias, int C,
    int c0, float (&mean)[VEC], float (&invstd)[VEC], float (&scale)[VEC],
    float (&shift)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = c0 + i < C ? c0 + i : C - 1;
    mean[i] = stats[c];
    invstd[i] = stats[C + c];
    scale[i] = invstd[i] * weight[c];
    shift[i] = bias[c];
  }
}

// backward sums: per (row chunk, channel) sum dz and sum dz * (x - mean)
template <int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    abn_bwd_reduce_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ dy,
                          const float* __restrict__ stats,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias,
                          float* __restrict__ part, int64_t R, int C, int tx,
                          int64_t rb_rows, float slope) {
  __shared__ float s_a[THREADS * VEC], s_b[THREADS * VEC];
  const Place p = place<VEC>(R, C, tx, rb_rows);
  float sa[VEC], sb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sa[i] = sb[i] = 0.f;
  if (p.active) {
    float mean[VEC], invstd[VEC], scale[VEC], shift[VEC];
    bwd_params<VEC>(stats, weight, bias, C, p.c0, mean, invstd, scale, shift);
    for (int64_t r0 = p.r_begin + p.ty; r0 < p.r_end;
         r0 += (int64_t)p.nty * UNROLL) {
      Raw<VEC> v[UNROLL], g[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t r = r0 + (int64_t)u * p.nty;
        if (r < p.r_end) {
          v[u] = load<VEC>(x + r * C + p.c0);
          g[u] = load<VEC>(dy + r * C + p.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r0 + (int64_t)u * p.nty < p.r_end) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float xv = widen<VEC>(v[u], i);
            const float xm = xv - mean[i];
            const float dz = act_grad(norm(xv, mean[i], scale[i], shift[i]),
                                      widen<VEC>(g[u], i), slope);
            sa[i] += dz;
            sb[i] = fmaf(dz, xm, sb[i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_a[slot(p, tx, i, p.ty)] = sa[i];
    s_b[slot(p, tx, i, p.ty)] = sb[i];
  }
  __syncthreads();
  for (int s = p.nty / 2; s > 0; s /= 2) {
    if (p.ty < s) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sa[i] += s_a[slot(p, tx, i, p.ty + s)];
        sb[i] += s_b[slot(p, tx, i, p.ty + s)];
        s_a[slot(p, tx, i, p.ty)] = sa[i];
        s_b[slot(p, tx, i, p.ty)] = sb[i];
      }
    }
    __syncthreads();
  }
  if (p.ty == 0 && p.active) {
    float* pa = part + (int64_t)blockIdx.y * C;
    float* pb = part + (int64_t)(gridDim.y + blockIdx.y) * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (p.c0 + i < C) {
        pa[p.c0 + i] = sa[i];
        pb[p.c0 + i] = sb[i];
      }
    }
  }
}

// dwb = [dW; dB] (2, C) in f32; coef = [mean of dz; projection] (2, C),
// both 0 in eval mode (the statistics are constants there)
__global__ void __launch_bounds__(THREADS)
    abn_bwd_finalize_kernel(const float* __restrict__ part,
                            const float* __restrict__ stats,
                            float* __restrict__ dwb, float* __restrict__ coef,
                            int64_t R, int C, int n_rb, int train) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * FIN_CH + threadIdx.x / 32;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int rb = lane; rb < n_rb; rb += 32) {
      a += part[(int64_t)rb * C + c];
      b += part[(int64_t)(n_rb + rb) * C + c];
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s /= 2) {
    a += __shfl_down_sync(0xffffffffu, a, s);
    b += __shfl_down_sync(0xffffffffu, b, s);
  }
  if (lane == 0 && c < C) {
    const float invstd = stats[C + c];
    dwb[c] = b * invstd;
    dwb[C + c] = a;
    coef[c] = train ? a / (float)R : 0.f;
    coef[C + c] = train ? b / (float)R * invstd * invstd : 0.f;
  }
}

// dx = (dz - mean(dz) - (x - mean) * proj) * invstd * w
template <int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    abn_bwd_apply_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ dy, bf16* __restrict__ dx,
                         const float* __restrict__ stats,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias,
                         const float* __restrict__ coef, int64_t R, int C,
                         int tx, int64_t rb_rows, float slope) {
  const Place p = place<VEC>(R, C, tx, rb_rows);
  if (!p.active) return;
  float mean[VEC], invstd[VEC], scale[VEC], shift[VEC], mdz[VEC], proj[VEC];
  bwd_params<VEC>(stats, weight, bias, C, p.c0, mean, invstd, scale, shift);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = p.c0 + i < C ? p.c0 + i : C - 1;
    mdz[i] = coef[c];
    proj[i] = coef[C + c];
  }
  for (int64_t r0 = p.r_begin + p.ty; r0 < p.r_end;
       r0 += (int64_t)p.nty * UNROLL) {
    Raw<VEC> v[UNROLL], g[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t r = r0 + (int64_t)u * p.nty;
      if (r < p.r_end) {
        v[u] = load<VEC>(x + r * C + p.c0);
        g[u] = load<VEC>(dy + r * C + p.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t r = r0 + (int64_t)u * p.nty;
      if (r < p.r_end) {
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xv = widen<VEC>(v[u], i);
          const float dz = act_grad(norm(xv, mean[i], scale[i], shift[i]),
                                    widen<VEC>(g[u], i), slope);
          out[i] = (dz - mdz[i] - (xv - mean[i]) * proj[i]) * scale[i];
        }
        store<VEC>(dx + r * C + p.c0, out);
      }
    }
  }
}

// the host's plan, checked: tx channel groups of vec a block row (a power
// of two up to 32), n_slices blocks across the channels, n_rb chunks of
// rb_rows rows (the last may be shorter, none empty)
bool plan_ok(int64_t R, int C, int vec, int tx, int n_slices, int n_rb,
             int64_t rb_rows) {
  if (R < 1 || C < 1 || (vec != 8 && vec != 1)) return false;
  if (tx < 1 || tx > 32 || (tx & (tx - 1)) != 0) return false;
  const int groups = (C + vec - 1) / vec;
  if (n_slices != (groups + tx - 1) / tx || n_slices > 65535) return false;
  if (n_rb < 1 || n_rb > MAX_ROW_BLOCKS || rb_rows < 1) return false;
  return rb_rows * (n_rb - 1) < R && rb_rows * n_rb >= R;
}

}  // namespace

#define PLAN_ARGS \
  int64_t R, int C, int vec, int tx, int n_slices, int n_rb, int64_t rb_rows

// Train forward. x, y (R, C) bf16; weight, bias, running_mean,
// running_var (C,) f32; stats (2, C) f32 out: [mean; invstd]; part
// (2 n_rb, C) f32 scratch.
extern "C" int ucd_abn_forward(const void* x, void* y, void* stats,
                               void* part, const void* weight,
                               const void* bias, void* running_mean,
                               void* running_var, PLAN_ARGS, float eps,
                               float slope, float momentum, int update,
                               void* stream) {
  if (!plan_ok(R, C, vec, tx, n_slices, n_rb, rb_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_slices, n_rb);
  if (vec == 8)
    abn_stats_kernel<8><<<grid, THREADS, 0, s>>>((const bf16*)x,
                                                 (float*)part, R, C, tx,
                                                 rb_rows);
  else
    abn_stats_kernel<1><<<grid, THREADS, 0, s>>>((const bf16*)x,
                                                 (float*)part, R, C, tx,
                                                 rb_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  abn_stats_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, THREADS, 0, s>>>(
      (const float*)part, (float*)stats, (float*)running_mean,
      (float*)running_var, R, C, n_rb, rb_rows, eps, momentum, update);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* st = (const float*)stats;
  if (vec == 8)
    abn_apply_kernel<8><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (bf16*)y, st, st + C, (const float*)weight,
        (const float*)bias, nullptr, R, C, tx, rb_rows, eps, slope, 0);
  else
    abn_apply_kernel<1><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (bf16*)y, st, st + C, (const float*)weight,
        (const float*)bias, nullptr, R, C, tx, rb_rows, eps, slope, 0);
  return (int)cudaGetLastError();
}

// Eval forward from the running statistics; saved (2, C) f32 out: [mean;
// invstd] for a backward.
extern "C" int ucd_abn_eval(const void* x, void* y, void* saved,
                            const void* weight, const void* bias,
                            const void* running_mean,
                            const void* running_var, PLAN_ARGS, float eps,
                            float slope, void* stream) {
  if (!plan_ok(R, C, vec, tx, n_slices, n_rb, rb_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_slices, n_rb);
  if (vec == 8)
    abn_apply_kernel<8><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (bf16*)y, (const float*)running_mean,
        (const float*)running_var, (const float*)weight, (const float*)bias,
        (float*)saved, R, C, tx, rb_rows, eps, slope, 1);
  else
    abn_apply_kernel<1><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (bf16*)y, (const float*)running_mean,
        (const float*)running_var, (const float*)weight, (const float*)bias,
        (float*)saved, R, C, tx, rb_rows, eps, slope, 1);
  return (int)cudaGetLastError();
}

// Backward. dy, dx (R, C) bf16; stats (2, C): the forward's [mean;
// invstd]; dwb (2, C) f32 out: [dW; dB]; part (2 n_rb + 2, C) f32
// scratch; train 0 for an eval-mode forward.
extern "C" int ucd_abn_backward(const void* x, const void* dy, void* dx,
                                const void* stats, const void* weight,
                                const void* bias, void* dwb, void* part,
                                PLAN_ARGS, float slope, int train,
                                void* stream) {
  if (!plan_ok(R, C, vec, tx, n_slices, n_rb, rb_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_slices, n_rb);
  const float* st = (const float*)stats;
  const float* w = (const float*)weight;
  const float* b = (const float*)bias;
  float* coef = (float*)part + (int64_t)2 * n_rb * C;
  if (vec == 8)
    abn_bwd_reduce_kernel<8><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)dy, st, w, b, (float*)part, R, C, tx,
        rb_rows, slope);
  else
    abn_bwd_reduce_kernel<1><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)dy, st, w, b, (float*)part, R, C, tx,
        rb_rows, slope);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  abn_bwd_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, THREADS, 0, s>>>(
      (const float*)part, st, (float*)dwb, coef, R, C, n_rb, train);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (vec == 8)
    abn_bwd_apply_kernel<8><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)dy, (bf16*)dx, st, w, b, coef, R, C, tx,
        rb_rows, slope);
  else
    abn_bwd_apply_kernel<1><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)dy, (bf16*)dx, st, w, b, coef, R, C, tx,
        rb_rows, slope);
  return (int)cudaGetLastError();
}
