// Fused bilinear upsample + argmax over classes, for Hopper (sm_90a).
//
// Replaces ucd_tpu/ops/fused_eval.py::_argmax_kernel (the Pallas kernel of
// the JAX serving and validate paths). Same function: bilinearly upsample
// the low-res logits z (B, h, w, C) with half-pixel centres and edge
// clamping to (H, W), then take the first-occurrence argmax over the C
// classes. The upsampled (B, H, W, C) logits are never written.
//
// Bound. At the serving shape (8, 32, 32, 21) f32 -> (8, 512, 512) the
// kernel must read 0.69 MB of logits and write 8.4 MB of int32 ids (2.7 us
// at 3.35 TB/s), and per output (pixel, class) do a height lerp of
// width-lerped rows and a compare (2.8 us at the f32 rate, counting each
// operation once). A first design (one thread per pixel, 4 gathered taps
// per class, a separate NaN-row launch) took 78 us on the device: 84 L1
// loads a pixel and a runtime class loop.
//
// Design. The output rows are cut into row cells (the host's `cells`):
// maximal runs of rows whose two F.interpolate taps read the same two
// source rows (16 rows at scale 16; 24 and 8 at the clamped edges). One
// block of 128 threads per (image, row cell, 128 output columns), one
// thread per column:
//  * the block first reads every source row of its rows' JAX windows (one
//    contiguous span of 3-4 rows x w x C, coalesced) and ORs a non-finite
//    test over it (__syncthreads_or). That read also brings the rows into
//    L1 for the taps below.
//  * finite rows (the fast path): each thread width-lerps its column's two
//    source rows once, for all classes, into registers (a template bound N
//    >= C, N a multiple of 8 up to 32; padded classes are -inf and never
//    win), then walks the cell's rows: per row and class one FMA (the
//    height lerp, written as top + ly * (bottom - top)) and a compare. The
//    ids are written coalesced, one 128-byte line per warp and row. Above
//    32 classes the thread gathers the 4 taps per (pixel, class) from L1
//    instead.
//  * a non-finite value in the span (the slow path): the block tallies,
//    per window row and class in shared memory, NaN and the count of +inf
//    and -inf, then evaluates the JAX kernel's rule exactly for each pixel
//    and class (below), from the host's per-row slot table and per-column
//    positive-column table. It costs nothing on finite inputs.
//
// The JAX kernel's non-finite rule. It upsamples with a dense width dot
// against its interpolation matrix and blends its tile's 3 slot rows with
// per-row weights, so for class c at (y, x): the dot of slot row r is NaN
// if row r holds a NaN of class c, or an inf at a column that x's matrix
// row weights 0, or both +inf and -inf at weighted columns; else ±inf if
// it holds an inf (all at weighted columns), else finite. A non-finite dot
// in a slot of weight 0 gives NaN (0 * inf); the slots' sum is NaN if any
// is NaN or +inf meets -inf. A finite result keeps F.interpolate's value
// (all its taps lie in the slot rows, so they are finite too). A NaN class
// gives class 0; otherwise the first maximum wins, +inf included, and all
// -inf gives class 0.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an argument the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // output columns of one block
constexpr int64_t MAX_SHARED = 227 * 1024;
// the slow path's tally of one (window row, class): a NaN bit, then the
// counts of +inf and of -inf (the host keeps w < 2^15)
constexpr unsigned NAN_BIT = 1u << 30, PINF_ONE = 1u << 15, NINF_ONE = 1u;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// F.interpolate's value of one class from its 4 taps
template <typename T>
__device__ __forceinline__ float interp(const T* p00, const T* p01,
                                        const T* p10, const T* p11, int c,
                                        float hy, float ly, float hx,
                                        float lx) {
  return hy * (hx * load_f32(p00 + c) + lx * load_f32(p01 + c)) +
         ly * (hx * load_f32(p10 + c) + lx * load_f32(p11 + c));
}

// the JAX kernel's value of class c at (y, x) when some slot row of y's
// window holds a non-finite value of c; `fin` (F.interpolate's) otherwise
template <typename T>
__device__ __forceinline__ float jax_value(
    float fin, const unsigned* tally, const T* img, int c, int C, int w,
    int rlo, int4 slots, int pc0, int pc1) {
  bool nan = false, pos = false, neg = false, any = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int r = j == 0 ? slots.x : j == 1 ? slots.y : slots.z;
    const unsigned code = tally[(r - rlo) * C + c];
    if (code == 0) continue;  // row r is finite in class c
    any = true;
    int kp = 0, kn = 0;  // infs at the columns x weights positively
    if (pc0 >= 0) {
      const float v = load_f32(img + ((int64_t)r * w + pc0) * C + c);
      kp += v == INFINITY;
      kn += v == -INFINITY;
    }
    if (pc1 >= 0) {
      const float v = load_f32(img + ((int64_t)r * w + pc1) * C + c);
      kp += v == INFINITY;
      kn += v == -INFINITY;
    }
    const bool dot_nan = (code & NAN_BIT) ||
                         (int)((code >> 15) & 0x7fff) > kp ||
                         (int)(code & 0x7fff) > kn || (kp > 0 && kn > 0);
    if (dot_nan || !((slots.w >> j) & 1)) {
      nan = true;  // NaN dot, or an inf times the slot's weight 0
    } else {
      pos |= kp > 0;
      neg |= kn > 0;
    }
  }
  if (!any) return fin;
  if (nan || (pos && neg)) return NAN;
  return pos ? INFINITY : -INFINITY;
}

// Block (column chunk, row cell, image). cells[k]: first row, end, the two
// F.interpolate source rows, the first and last JAX window row; yplan[y]:
// y's 3 window slots and their positive-weight bits; xplan[x]: the two
// F.interpolate source columns and the JAX positive columns (-1 for none).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    fused_argmax_kernel(const T* __restrict__ z, const int4* __restrict__ cells,
                        const int4* __restrict__ yplan,
                        const float* __restrict__ fy,
                        const int4* __restrict__ xplan,
                        const float* __restrict__ fx,
                        int32_t* __restrict__ out, int h, int w, int C, int H,
                        int W) {
  extern __shared__ unsigned tally[];
  const int b = blockIdx.z;
  const int4 cell = cells[2 * blockIdx.y], span = cells[2 * blockIdx.y + 1];
  const int first = cell.x, end = cell.y, rlo = span.x, rhi = span.y;
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const int64_t row_len = (int64_t)w * C;
  const T* img = z + (int64_t)b * h * row_len;
  const T* win = img + rlo * row_len;
  const int64_t n = (rhi - rlo + 1) * row_len;

  bool bad = false;
  for (int64_t i = threadIdx.x; i < n; i += THREADS)
    bad |= !isfinite(load_f32(win + i));
  if (__syncthreads_or(bad)) {
    // slow path: tally the window rows, then the JAX rule per pixel
    for (int i = threadIdx.x; i < (rhi - rlo + 1) * C; i += THREADS)
      tally[i] = 0;
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n; i += THREADS) {
      const float v = load_f32(win + i);
      if (isfinite(v)) continue;
      unsigned* t = tally + (int)(i / row_len) * C + (int)(i % C);
      if (isnan(v))
        atomicOr(t, NAN_BIT);
      else
        atomicAdd(t, v > 0 ? PINF_ONE : NINF_ONE);
    }
    __syncthreads();
    if (x >= W) return;
    const int4 xp = xplan[x];
    const float lx = fx[x], hx = 1.0f - lx;
    const T* r0 = img + cell.z * row_len;
    const T* r1 = img + cell.w * row_len;
    for (int y = first; y < end; ++y) {
      const int4 slots = yplan[y];
      const float ly = fy[y], hy = 1.0f - ly;
      float best = 0.0f;
      int arg = 0;
      for (int c = 0; c < C; ++c) {
        const float fin =
            interp(r0 + xp.x * C, r0 + xp.y * C, r1 + xp.x * C,
                   r1 + xp.y * C, c, hy, ly, hx, lx);
        const float v =
            jax_value(fin, tally, img, c, C, w, rlo, slots, xp.z, xp.w);
        if (isnan(v)) {
          arg = 0;
          break;
        }
        if (c == 0 || v > best) {  // strict: the first maximum wins
          best = v;
          arg = c;
        }
      }
      out[((int64_t)b * H + y) * W + x] = arg;
    }
    return;
  }
  if (x >= W) return;

  const int4 xp = xplan[x];
  const float lx = fx[x], hx = 1.0f - lx;
  const T* p00 = img + cell.z * row_len + xp.x * C;
  const T* p01 = img + cell.z * row_len + xp.y * C;
  const T* p10 = img + cell.w * row_len + xp.x * C;
  const T* p11 = img + cell.w * row_len + xp.y * C;
  int32_t* o = out + ((int64_t)b * H + first) * W + x;
  if (N == 0) {  // above 32 classes: 4 taps per (pixel, class) from L1
    for (int y = first; y < end; ++y, o += W) {
      const float ly = fy[y], hy = 1.0f - ly;
      float best = interp(p00, p01, p10, p11, 0, hy, ly, hx, lx);
      int arg = 0;
      for (int c = 1; c < C; ++c) {
        const float v = interp(p00, p01, p10, p11, c, hy, ly, hx, lx);
        if (v > best) {
          best = v;
          arg = c;
        }
      }
      *o = arg;
    }
    return;
  }
  constexpr int NR = N > 0 ? N : 1;
  __builtin_assume(C > NR - 8);
  float top[NR], dif[NR];  // width lerp of the two source rows
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < C) {
      top[c] = hx * load_f32(p00 + c) + lx * load_f32(p01 + c);
      dif[c] = hx * load_f32(p10 + c) + lx * load_f32(p11 + c) - top[c];
    } else {
      top[c] = -INFINITY;  // never wins: -inf + ly * 0
      dif[c] = 0.0f;
    }
  }
  for (int y = first; y < end; ++y, o += W) {
    const float ly = fy[y];
    float best = fmaf(ly, dif[0], top[0]);
    int arg = 0;
#pragma unroll
    for (int c = 1; c < NR; ++c) {
      const float v = fmaf(ly, dif[c], top[c]);
      arg = v > best ? c : arg;
      best = fmaxf(best, v);
    }
    *o = arg;
  }
}

template <typename T, int N>
cudaError_t launch_n(const void* z, const void* cells, const void* yplan,
                     const void* fy, const void* xplan, const void* fx,
                     void* out, int B, int h, int w, int C, int H, int W,
                     int n_cells, int smem, cudaStream_t stream) {
  auto kernel = fused_argmax_kernel<T, N>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + THREADS - 1) / THREADS, n_cells, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)z, (const int4*)cells, (const int4*)yplan, (const float*)fy,
      (const int4*)xplan, (const float*)fx, (int32_t*)out, h, w, C, H, W);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* z, const void* cells, const void* yplan,
           const void* fy, const void* xplan, const void* fx, void* out, int B,
           int h, int w, int C, int H, int W, int n_cells, int smem,
           void* stream) {
  if (B < 1 || B > 65535 || n_cells < 1 || n_cells > 65535 || C < 1 ||
      w < 1 || w >= (1 << 15) || H < 1 || W < 1 || smem < 0 ||
      smem > MAX_SHARED)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define ARGS z, cells, yplan, fy, xplan, fx, out, B, h, w, C, H, W, n_cells, \
             smem, s
  cudaError_t e;
  if (C <= 8)
    e = launch_n<T, 8>(ARGS);
  else if (C <= 16)
    e = launch_n<T, 16>(ARGS);
  else if (C <= 24)
    e = launch_n<T, 24>(ARGS);
  else if (C <= 32)
    e = launch_n<T, 32>(ARGS);
  else
    e = launch_n<T, 0>(ARGS);
#undef ARGS
  return (int)e;
}

}  // namespace

// z (B, h, w, C) float32 / bfloat16; cells (n_cells, 8), yplan (H, 4) and
// xplan (W, 4) int32 and fy (H,) / fx (W,) float32: the host's tables
// (ops/fused_eval.py `argmax_plan`); out (B, H, W) int32; smem: the most
// window rows of a cell times C times 4 bytes.
extern "C" int ucd_fused_argmax_f32(const void* z, const void* cells,
                                    const void* yplan, const void* fy,
                                    const void* xplan, const void* fx,
                                    void* out, int B, int h, int w, int C,
                                    int H, int W, int n_cells, int smem,
                                    void* stream) {
  return launch<float>(z, cells, yplan, fy, xplan, fx, out, B, h, w, C, H, W,
                       n_cells, smem, stream);
}

extern "C" int ucd_fused_argmax_bf16(const void* z, const void* cells,
                                     const void* yplan, const void* fy,
                                     const void* xplan, const void* fx,
                                     void* out, int B, int h, int w, int C,
                                     int H, int W, int n_cells, int smem,
                                     void* stream) {
  return launch<__nv_bfloat16>(z, cells, yplan, fy, xplan, fx, out, B, h, w,
                               C, H, W, n_cells, smem, stream);
}
