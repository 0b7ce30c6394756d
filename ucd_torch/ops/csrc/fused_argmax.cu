// Fused bilinear upsample + argmax over classes, for Hopper (sm_90a).
//
// Replaces ucd_tpu/ops/fused_eval.py::_argmax_kernel (the Pallas kernel of
// the JAX serving and validate paths). Same function: bilinearly upsample
// the low-res logits z (B, h, w, C) with half-pixel centres and edge
// clamping to (H, W), then take the first-occurrence argmax over the C
// classes. The upsampled (B, H, W, C) logits are never written: each
// thread interpolates its pixel's C values in registers and keeps only the
// running max and its index.
//
// Bound: bytes. At the serving shape (8, 32, 32, 21) f32 -> (8, 512, 512)
// the kernel must read B*h*w*C*4 = 0.69 MB and write B*H*W*4 = 8.4 MB of
// int32 ids, about 9 MB, i.e. ~2.7 us at 3.35 TB/s; its ~4 flops per output
// (pixel, class) are of the same order at the f32 CUDA-core rate. The TPU
// kernel's MXU dot against a dense interpolation matrix has no reason to
// exist here: bilinear is a gather of 4 taps, read from 1-D tap tables
// (index0, index1, frac) for H and for W that the host builds once per shape.
//
// Design: one thread per output pixel; blockIdx.y is the output row and
// blockIdx.z the image, so the row taps are uniform across a block and the
// 16-fold reuse of each source pixel by neighbouring threads is served by
// L1. The arithmetic follows torch.nn.functional.interpolate(bilinear,
// align_corners=False): h0*(w0*a + w1*b) + h1*(w0*c + w1*d), all four taps
// read even where a weight is 0, so NaN reaches the same pixels as in the
// plain version.
//
// NaN rule (the JAX kernel's). The JAX kernel upsamples the width with a
// dense dot over whole source rows, so a NaN anywhere in the 3-row source
// window of an output tile reaches every pixel of the tile's rows through
// 0 * NaN, and its argmax maps a NaN pixel to class 0. Here a first kernel
// (`nan_rows_kernel`, one warp per source row of one image) flags the
// source rows that hold a NaN; the argmax kernel reads the flags of its
// output row's window (the host's table `win`, 3 source rows per output
// row, from the JAX tile plan) and writes class 0 for the whole row when
// one is set. A pixel whose own upsampled value is NaN (an inf times a zero
// weight) also gets class 0, as in the plain version. Two launches per
// call, no host sync.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

constexpr int ROWS_PER_BLOCK = 8;  // warps of nan_rows_kernel

// row_nan[r] = 1 if source row r (of B * h, each w * C contiguous values)
// holds a NaN, else 0
template <typename T>
__global__ void nan_rows_kernel(const T* __restrict__ z,
                                uint8_t* __restrict__ row_nan, int n_rows,
                                int row_len) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* p = z + (int64_t)row * row_len;
  bool nan = false;
  for (int i = lane; i < row_len; i += 32) nan |= isnan(load_f32(p + i));
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) row_nan[row] = nan ? 1 : 0;
}

template <typename T>
__global__ void fused_argmax_kernel(const T* __restrict__ z,
                                    const int32_t* __restrict__ iy0,
                                    const int32_t* __restrict__ iy1,
                                    const float* __restrict__ fy,
                                    const int32_t* __restrict__ ix0,
                                    const int32_t* __restrict__ ix1,
                                    const float* __restrict__ fx,
                                    const int32_t* __restrict__ win,
                                    const uint8_t* __restrict__ row_nan,
                                    int32_t* __restrict__ out, int h, int w,
                                    int C, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const uint8_t* flags = row_nan + (int64_t)b * h;
  if (flags[win[3 * y]] | flags[win[3 * y + 1]] | flags[win[3 * y + 2]]) {
    out[((int64_t)b * H + y) * W + x] = 0;  // a NaN in the tile's window
    return;
  }

  const float ly = fy[y];
  const float hy = 1.0f - ly;
  const float lx = fx[x];
  const float hx = 1.0f - lx;
  const int64_t row0 = ((int64_t)b * h + iy0[y]) * w;
  const int64_t row1 = ((int64_t)b * h + iy1[y]) * w;
  const T* p00 = z + (row0 + ix0[x]) * C;
  const T* p01 = z + (row0 + ix1[x]) * C;
  const T* p10 = z + (row1 + ix0[x]) * C;
  const T* p11 = z + (row1 + ix1[x]) * C;

  float best = 0.0f;
  int32_t arg = 0;
  for (int c = 0; c < C; ++c) {
    const float v = hy * (hx * load_f32(p00 + c) + lx * load_f32(p01 + c)) +
                    ly * (hx * load_f32(p10 + c) + lx * load_f32(p11 + c));
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

template <typename T>
int launch(const void* z, const void* iy0, const void* iy1, const void* fy,
           const void* ix0, const void* ix1, const void* fx, const void* win,
           void* row_nan, void* out, int B, int h, int w, int C, int H, int W,
           void* stream) {
  const int threads = 128;
  const int n_rows = B * h;
  nan_rows_kernel<T><<<(n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                       ROWS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const T*)z, (uint8_t*)row_nan, n_rows, w * C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + threads - 1) / threads, H, B);
  fused_argmax_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const int32_t*)iy0, (const int32_t*)iy1, (const float*)fy,
      (const int32_t*)ix0, (const int32_t*)ix1, (const float*)fx,
      (const int32_t*)win, (const uint8_t*)row_nan, (int32_t*)out, h, w, C, H,
      W);
  return (int)cudaGetLastError();
}

}  // namespace

// z (B, h, w, C) float32 / bfloat16; the six tap tables of H and W; win
// (H, 3) int32 source rows of each output row's NaN window; row_nan uint8
// scratch of B * h; out (B, H, W) int32.
extern "C" int ucd_fused_argmax_f32(const void* z, const void* iy0,
                                    const void* iy1, const void* fy,
                                    const void* ix0, const void* ix1,
                                    const void* fx, const void* win,
                                    void* row_nan, void* out, int B, int h,
                                    int w, int C, int H, int W, void* stream) {
  return launch<float>(z, iy0, iy1, fy, ix0, ix1, fx, win, row_nan, out, B, h,
                       w, C, H, W, stream);
}

extern "C" int ucd_fused_argmax_bf16(const void* z, const void* iy0,
                                     const void* iy1, const void* fy,
                                     const void* ix0, const void* ix1,
                                     const void* fx, const void* win,
                                     void* row_nan, void* out, int B, int h,
                                     int w, int C, int H, int W,
                                     void* stream) {
  return launch<__nv_bfloat16>(z, iy0, iy1, fy, ix0, ix1, fx, win, row_nan,
                               out, B, h, w, C, H, W, stream);
}
