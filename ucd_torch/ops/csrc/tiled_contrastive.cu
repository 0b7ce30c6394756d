// Streaming (tiled) UCD pixel-contrastive loss, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the three Pallas kernels of ucd_tpu/ops/pallas_contrastive.py:
//
//   contrastive_pass1_kernel  <-  ::_pass1_kernel   per anchor i
//       neg_i = sum_j mask_n exp(a_i.c_j / tau),  num_i = sum_j mask_p
//   contrastive_pass2_kernel  <-  ::_pass2_kernel   with neg_i complete
//       S_i = sum_j mask_p JM_ij (adc_ij - log(exp(adc_ij) + neg_i))
//       G_i = sum_j mask_p JM_ij / (exp(adc_ij) + neg_i)
//   contrastive_bwd_kernel    <-  ::_bwd_kernel
//       dA_i = sum_j coef_i [mask_p JM_ij (1 - e_ij / (e_ij + neg_i))
//                            - mask_n e_ij G_i] c_j / tau
//
// with adc = A C^T / tau over P anchors (P, D) and M contrast slots (M, D),
// JM = Pa Pc^T over the old model's class probabilities (P, C), (M, C),
// forced to 1 where both slots are GT-new; mask_p = same label, both slots
// valid, not the self-pair (global row == column); mask_n = different
// label, both valid. Neither the P x M similarity matrix nor the JM matrix
// ever exists in device memory. Features are L2-normalized, so
// |adc| <= 1/tau and no running max is needed; expf / logf stay the
// accurate f32 functions.
//
// Bound: operations. At the train shape (P 8192, M 16384, D 256, C 16) one
// similarity product is 68.7 GFLOP against 25 MB of inputs; pass 1 does one,
// pass 2 one plus the JM product, the backward two plus JM.
//
// Two variants, chosen by the wrapper from the compute mode alone:
//
//  * f32 mode: the f32-FMA kernels of this file.
//    Every product is true f32 FMAs (never TF32). One block of 256 threads
//    owns a tile of 64 anchors and walks all contrast tiles (64 slots each)
//    itself, so neg / num / S / G and the dA tile stay in registers for the
//    whole loop and no cross-block reduction or atomic exists: every sum has
//    a fixed order and two runs give the same bits. Each 64 x 64 pair tile
//    is a shared-memory product: K-chunks of 32 of both operands are staged
//    transposed ([k][slot], padded) so that a thread reads its 4 anchors and
//    4 contrast slots as two float4 and does 16 FMAs per k; the next chunk's
//    global loads go into registers before the current chunk is multiplied.
//    The masked exp / log epilogue runs on the thread's 4 x 4 sub-tile
//    straight from the accumulators; the ragged edges (P, M, D, C not
//    multiples of the tiles) are zero-filled on load and masked by the
//    validity bits, so no padded copy of any input is made. The backward
//    stages the pair tile dL/dadc through shared memory ([slot][anchor]) and
//    contracts it with the contrast features again, a 64 x 256 slice of dA
//    per block (64 accumulators per thread; blockIdx.y walks wider D).
//
//  * bf16 mode: the tensor-core kernels of tiled_contrastive_mma.cuh
//    (`mma.sync` on 2-byte operands, the anchor tile resident in shared
//    memory, a `cp.async` ring of contrast tiles, dL/dadc handed from the
//    first product's accumulators to the second product's A fragments in
//    registers); its header has the design.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an argument the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiled_contrastive_mma.cuh"

namespace {

constexpr int TA = 64;        // anchors per block
constexpr int TC = 64;        // contrast slots per tile
constexpr int DK = 32;        // K-chunk of a staged product
constexpr int PAD = TA + 4;   // row pitch of the staged chunks (16 B aligned)
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int DB = 256;       // columns of dA per backward block
constexpr int CK = 16;        // contrast slots per chunk of the 2nd product
constexpr int LD = TA / (THREADS / DK);  // staged loads per thread and operand

static_assert(TA == TC, "one loop stages both operands");
static_assert(CK * DB <= 2 * DK * PAD, "the Cf chunk reuses the A/B buffers");
static_assert(DB == THREADS, "one column of the Cf chunk per thread");

// labels and flag bits (1 = valid, 2 = GT-new) of 4 consecutive slots;
// slots at or beyond n are invalid
__device__ __forceinline__ void load_slots(const Slots& s, int first, int n,
                                           int (&lab)[4], int (&flag)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = first + k;
    lab[k] = 0;
    flag[k] = 0;
    if (idx < n) {
      lab[k] = s.label[idx];
      flag[k] = (s.valid[idx] ? 1 : 0) | (s.is_new[idx] ? 2 : 0);
    }
  }
}

// one K-chunk of both operands, from global memory into registers
__device__ __forceinline__ void fetch_chunk(float (&ra)[LD], float (&rb)[LD],
                                            const float* __restrict__ a,
                                            int row0, int n_rows,
                                            const float* __restrict__ b,
                                            int col0, int n_cols, int K,
                                            int k0) {
  const int k = k0 + (threadIdx.x & (DK - 1));
  const int lr = threadIdx.x / DK;
#pragma unroll
  for (int s = 0; s < LD; ++s) {
    const int r = lr + s * (THREADS / DK);
    const int ga = row0 + r, gb = col0 + r;
    ra[s] = (k < K && ga < n_rows) ? __ldg(a + (int64_t)ga * K + k) : 0.0f;
    rb[s] = (k < K && gb < n_cols) ? __ldg(b + (int64_t)gb * K + k) : 0.0f;
  }
}

// acc[i][j] += sum_k a[row0 + ty*4 + i][k] * b[col0 + tx*4 + j][k], rows and
// columns beyond n_rows / n_cols and k beyond K read as 0. All threads of
// the block call it together; As / Bs are free again when it returns.
__device__ __forceinline__ void tile_product(float (&acc)[4][4],
                                             const float* __restrict__ a,
                                             int row0, int n_rows,
                                             const float* __restrict__ b,
                                             int col0, int n_cols, int K,
                                             float (*As)[PAD],
                                             float (*Bs)[PAD]) {
  const int lk = threadIdx.x & (DK - 1);
  const int lr = threadIdx.x / DK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float ra[LD], rb[LD];
  fetch_chunk(ra, rb, a, row0, n_rows, b, col0, n_cols, K, 0);
  for (int k0 = 0; k0 < K; k0 += DK) {
#pragma unroll
    for (int s = 0; s < LD; ++s) {
      const int r = lr + s * (THREADS / DK);
      As[lk][r] = ra[s];
      Bs[lk][r] = rb[s];
    }
    __syncthreads();
    if (k0 + DK < K)
      fetch_chunk(ra, rb, a, row0, n_rows, b, col0, n_cols, K, k0 + DK);
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// sum over the 16 threads (tx) that share a row: they are the 16 lanes of a
// half-warp, and the butterfly leaves the same bits in each
__device__ __forceinline__ float row_sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__device__ __forceinline__ void zero_tile(float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = 0.0f;
}

__global__ void __launch_bounds__(THREADS)
    contrastive_pass1_kernel(const float* __restrict__ af,
                             const float* __restrict__ cf, Slots a_slots,
                             Slots c_slots, float* __restrict__ neg,
                             float* __restrict__ num, int P, int M, int D,
                             float tau) {
  __shared__ __align__(16) float As[DK][PAD];
  __shared__ __align__(16) float Bs[DK][PAD];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * TA;
  int lab_a[4], flag_a[4];
  load_slots(a_slots, row0 + ty * 4, P, lab_a, flag_a);
  float neg_p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float num_p[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int col0 = 0; col0 < M; col0 += TC) {
    float acc[4][4];
    zero_tile(acc);
    tile_product(acc, af, row0, P, cf, col0, M, D, As, Bs);
    int lab_c[4], flag_c[4];
    load_slots(c_slots, col0 + tx * 4, M, lab_c, flag_c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!(flag_a[i] & flag_c[j] & 1)) continue;  // pair not valid
        if (lab_a[i] == lab_c[j]) {
          if (row != col0 + tx * 4 + j) num_p[i] += 1.0f;
        } else {
          neg_p[i] += expf(acc[i][j] / tau);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float n = row_sum16(neg_p[i]);
    const float c = row_sum16(num_p[i]);
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < P) {
      neg[row] = n;
      num[row] = c;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    contrastive_pass2_kernel(const float* __restrict__ af,
                             const float* __restrict__ ap,
                             const float* __restrict__ cf,
                             const float* __restrict__ cp, Slots a_slots,
                             Slots c_slots, const float* __restrict__ neg,
                             float* __restrict__ s_out,
                             float* __restrict__ g_out, int P, int M, int D,
                             int C, float tau) {
  __shared__ __align__(16) float As[DK][PAD];
  __shared__ __align__(16) float Bs[DK][PAD];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * TA;
  int lab_a[4], flag_a[4];
  load_slots(a_slots, row0 + ty * 4, P, lab_a, flag_a);
  float neg_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    neg_r[i] = row < P ? neg[row] : 0.0f;
  }
  float s_p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float g_p[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int col0 = 0; col0 < M; col0 += TC) {
    float jm[4][4], acc[4][4];
    zero_tile(jm);
    zero_tile(acc);
    tile_product(jm, ap, row0, P, cp, col0, M, C, As, Bs);
    tile_product(acc, af, row0, P, cf, col0, M, D, As, Bs);
    int lab_c[4], flag_c[4];
    load_slots(c_slots, col0 + tx * 4, M, lab_c, flag_c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int both = flag_a[i] & flag_c[j];
        const bool mask_p = (both & 1) && lab_a[i] == lab_c[j] &&
                            row != col0 + tx * 4 + j;
        if (!mask_p) continue;
        const float w = (both & 2) ? 1.0f : jm[i][j];
        const float adc = acc[i][j] / tau;
        const float denom = expf(adc) + neg_r[i];
        s_p[i] += w * (adc - logf(denom));
        g_p[i] += w / denom;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = row_sum16(s_p[i]);
    const float g = row_sum16(g_p[i]);
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < P) {
      s_out[row] = s;
      g_out[row] = g;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    contrastive_bwd_kernel(const float* __restrict__ af,
                           const float* __restrict__ ap,
                           const float* __restrict__ cf,
                           const float* __restrict__ cp, Slots a_slots,
                           Slots c_slots,
                           const float* __restrict__ neg,
                           const float* __restrict__ g_row,
                           const float* __restrict__ coef,
                           float* __restrict__ da_out, int P, int M, int D,
                           int C, float tau) {
  __shared__ __align__(16) float AB[2][DK][PAD];
  __shared__ __align__(16) float Ds[TC][PAD];  // dL/dadc, [slot][anchor]
  float(*As)[PAD] = AB[0];
  float(*Bs)[PAD] = AB[1];
  float(*Cs)[DB] = reinterpret_cast<float(*)[DB]>(&AB[0][0][0]);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * TA;
  const int d0 = blockIdx.y * DB;
  int lab_a[4], flag_a[4];
  load_slots(a_slots, row0 + ty * 4, P, lab_a, flag_a);
  float neg_r[4], g_r[4], coef_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    neg_r[i] = row < P ? neg[row] : 0.0f;
    g_r[i] = row < P ? g_row[row] : 0.0f;
    coef_r[i] = row < P ? coef[row] : 0.0f;
  }
  // this thread's part of the dA tile: anchors ty*4 + i, columns
  // d0 + q*64 + tx*4 + jj at da[i][q*4 + jj]
  float da[4][DB / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DB / 16; ++c) da[i][c] = 0.0f;

  for (int col0 = 0; col0 < M; col0 += TC) {
    float jm[4][4], acc[4][4];
    zero_tile(jm);
    zero_tile(acc);
    tile_product(jm, ap, row0, P, cp, col0, M, C, As, Bs);
    tile_product(acc, af, row0, P, cf, col0, M, D, As, Bs);
    int lab_c[4], flag_c[4];
    load_slots(c_slots, col0 + tx * 4, M, lab_c, flag_c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int both = flag_a[i] & flag_c[j];
        float dadc = 0.0f;
        if (both & 1) {
          const float e = expf(acc[i][j] / tau);
          if (lab_a[i] != lab_c[j]) {
            dadc = coef_r[i] * -(e * g_r[i]);
          } else if (row0 + ty * 4 + i != col0 + tx * 4 + j) {
            const float w = (both & 2) ? 1.0f : jm[i][j];
            dadc = coef_r[i] * (w * (1.0f - e / (e + neg_r[i])));
          }
        }
        col[i] = dadc;
      }
      *reinterpret_cast<float4*>(&Ds[tx * 4 + j][ty * 4]) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
    __syncthreads();

    // dA tile += Ds^T (64 anchors x 64 slots) . Cf[col0 .. col0+64, d0 ..]
    for (int c0 = 0; c0 < TC; c0 += CK) {
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        const int gc = col0 + c0 + cc, gd = d0 + threadIdx.x;
        Cs[cc][threadIdx.x] =
            (gc < M && gd < D) ? __ldg(cf + (int64_t)gc * D + gd) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        const float4 dv =
            *reinterpret_cast<const float4*>(&Ds[c0 + cc][ty * 4]);
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int q = 0; q < DB / 64; ++q) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&Cs[cc][q * 64 + tx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              da[i][q * 4 + jj] = fmaf(dr[i], cr[jj], da[i][q * 4 + jj]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= P) continue;
#pragma unroll
    for (int q = 0; q < DB / 64; ++q)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = d0 + q * 64 + tx * 4 + jj;
        if (d < D) da_out[(int64_t)row * D + d] = da[i][q * 4 + jj] / tau;
      }
  }
}

struct Args {
  const float *af, *ap, *cf, *cp;
  Slots a_slots, c_slots;
  int P, M, D, C;
  float tau;
  cudaStream_t stream;
};

bool args_ok(const Args& a) {
  return a.P >= 1 && a.M >= 1 && a.D >= 1 && a.C >= 1 && a.tau > 0.0f;
}

Args make_args(const void* af, const void* ap, const void* cf, const void* cp,
               const void* la, const void* av, const void* an, const void* lc,
               const void* cv, const void* cn, int P, int M, int D, int C,
               float tau, void* stream) {
  Args a;
  a.af = (const float*)af;
  a.ap = (const float*)ap;
  a.cf = (const float*)cf;
  a.cp = (const float*)cp;
  a.a_slots = {(const int32_t*)la, (const uint8_t*)av, (const uint8_t*)an};
  a.c_slots = {(const int32_t*)lc, (const uint8_t*)cv, (const uint8_t*)cn};
  a.P = P;
  a.M = M;
  a.D = D;
  a.C = C;
  a.tau = tau;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

// The f32-FMA kernels. Features af (P, D), cf (M, D) and probabilities ap
// (P, C), cp (M, C) are float32, row-major; la / lc int32 labels, av / cv /
// an / cn one byte per slot (validity, GT-new); neg, num, s, g, coef (P,)
// and da (P, D) float32.

extern "C" int ucd_contrastive_pass1(
    const void* af, const void* cf, const void* la, const void* av,
    const void* an, const void* lc, const void* cv, const void* cn, void* neg,
    void* num, int P, int M, int D, float tau, void* stream) {
  const Args a = make_args(af, nullptr, cf, nullptr, la, av, an, lc, cv, cn, P,
                           M, D, 1, tau, stream);
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  contrastive_pass1_kernel<<<(a.P + TA - 1) / TA, THREADS, 0, a.stream>>>(
      a.af, a.cf, a.a_slots, a.c_slots, (float*)neg, (float*)num, a.P, a.M,
      a.D, a.tau);
  return (int)cudaGetLastError();
}

extern "C" int ucd_contrastive_pass2(
    const void* af, const void* ap, const void* cf, const void* cp,
    const void* la, const void* av, const void* an, const void* lc,
    const void* cv, const void* cn, const void* neg, void* s, void* g, int P,
    int M, int D, int C, float tau, void* stream) {
  const Args a =
      make_args(af, ap, cf, cp, la, av, an, lc, cv, cn, P, M, D, C, tau, stream);
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  contrastive_pass2_kernel<<<(a.P + TA - 1) / TA, THREADS, 0, a.stream>>>(
      a.af, a.ap, a.cf, a.cp, a.a_slots, a.c_slots, (const float*)neg,
      (float*)s, (float*)g, a.P, a.M, a.D, a.C, a.tau);
  return (int)cudaGetLastError();
}

extern "C" int ucd_contrastive_bwd(
    const void* af, const void* ap, const void* cf, const void* cp,
    const void* la, const void* av, const void* an, const void* lc,
    const void* cv, const void* cn, const void* neg, const void* g,
    const void* coef, void* da, int P, int M, int D, int C, float tau,
    void* stream) {
  const Args a =
      make_args(af, ap, cf, cp, la, av, an, lc, cv, cn, P, M, D, C, tau, stream);
  const dim3 grid((a.P + TA - 1) / TA, (a.D + DB - 1) / DB);
  if (!args_ok(a) || grid.y > 65535) return (int)cudaErrorInvalidValue;
  contrastive_bwd_kernel<<<grid, THREADS, 0, a.stream>>>(
      a.af, a.ap, a.cf, a.cp, a.a_slots, a.c_slots, (const float*)neg,
      (const float*)g, (const float*)coef, (float*)da, a.P, a.M, a.D, a.C,
      a.tau);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 mode: the tensor-core kernels of tiled_contrastive_mma.cuh
// ---------------------------------------------------------------------------

namespace {

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Operands of the tensor-core kernels, or stages = 0 for arguments they do
// not take. af / ap / cf / cp are bf16, zero-padded by the wrapper: P to a
// multiple of `tile_a`, M of 64, D and C of 16; every slot array padded
// alike (padded slots invalid) and 16-byte aligned for cp.async. C = 0 with
// null ap / cp: no probabilities (pass 1).
mma::Operands mma_operands(const void* af, const void* ap, const void* cf,
                           const void* cp, const void* la, const void* av,
                           const void* an, const void* lc, const void* cv,
                           const void* cn, int P, int M, int D, int C,
                           float tau, int parts, int stages, int tile_a) {
  mma::Operands t;
  t.af = (const __nv_bfloat16*)af;
  t.ap = (const __nv_bfloat16*)ap;
  t.cf = (const __nv_bfloat16*)cf;
  t.cp = (const __nv_bfloat16*)cp;
  t.a_slots = {(const int32_t*)la, (const uint8_t*)av, (const uint8_t*)an};
  t.c_slots = {(const int32_t*)lc, (const uint8_t*)cv, (const uint8_t*)cn};
  t.P = P;
  t.M = M;
  t.D = D;
  t.C = C;
  t.tau = tau;
  t.stages = 0;
  t.tiles_per_part = 0;
  if (P < 1 || M < 1 || D < 1 || C < 0 || !(tau > 0.0f) || parts < 1 ||
      parts > 65535 || stages < 2 || stages > 4 || P % tile_a || M % mma::TC ||
      D % 16 || C % 16 || (C == 0) != (ap == nullptr && cp == nullptr))
    return t;
  if (!(aligned16(af) && aligned16(ap) && aligned16(cf) && aligned16(cp) &&
        aligned16(lc) && aligned16(cv) && aligned16(cn)))
    return t;
  const int n_tiles = M / mma::TC;
  const int per_part = (n_tiles + parts - 1) / parts;
  if ((parts - 1) * per_part >= n_tiles) return t;  // a part without a tile
  const mma::Geometry geo = mma::geometry(D, C, tile_a);
  if (geo.anchors + stages * geo.stage > mma::SMEM_LIMIT) return t;
  t.tiles_per_part = per_part;
  t.stages = stages;
  return t;
}

template <typename Kernel, typename... Args>
int launch_mma(Kernel kernel, dim3 grid, int threads, const mma::Operands& t,
               int tile_a, void* stream, Args... args) {
  const mma::Geometry geo = mma::geometry(t.D, t.C, tile_a);
  const int smem = geo.anchors + t.stages * geo.stage;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(t, args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1 on the tensor cores. neg, num: float32 (parts, P), one row of
// partial sums per part of the walk over M. tile_a: anchors per block, 128
// (8 warps) or 256 (16 warps).
extern "C" int ucd_contrastive_pass1_mma(
    const void* af, const void* cf, const void* la, const void* av,
    const void* an, const void* lc, const void* cv, const void* cn, void* neg,
    void* num, int P, int M, int D, float tau, int parts, int stages,
    int tile_a, void* stream) {
  if (tile_a != 128 && tile_a != 256) return (int)cudaErrorInvalidValue;
  const mma::Operands t =
      mma_operands(af, nullptr, cf, nullptr, la, av, an, lc, cv, cn, P, M, D,
                   0, tau, parts, stages, tile_a);
  if (!t.stages) return (int)cudaErrorInvalidValue;
  const dim3 grid(P / tile_a, parts);
  if (tile_a == 128)
    return launch_mma(mma::contrastive_pass1_mma_kernel<8>, grid, 256, t,
                      tile_a, stream, (float*)neg, (float*)num);
  return launch_mma(mma::contrastive_pass1_mma_kernel<16>, grid, 512, t,
                    tile_a, stream, (float*)neg, (float*)num);
}

// Pass 2 on the tensor cores. s, g: float32 (parts, P), one row of partial
// sums per part of the walk over M; neg float32 (P,). tile_a: anchors per
// block, 128 (8 warps) or 256 (16 warps).
extern "C" int ucd_contrastive_pass2_mma(
    const void* af, const void* ap, const void* cf, const void* cp,
    const void* la, const void* av, const void* an, const void* lc,
    const void* cv, const void* cn, const void* neg, void* s, void* g, int P,
    int M, int D, int C, float tau, int parts, int stages, int tile_a,
    void* stream) {
  if ((tile_a != 128 && tile_a != 256) || C < 1)
    return (int)cudaErrorInvalidValue;
  const mma::Operands t = mma_operands(af, ap, cf, cp, la, av, an, lc, cv, cn,
                                       P, M, D, C, tau, parts, stages, tile_a);
  if (!t.stages) return (int)cudaErrorInvalidValue;
  const dim3 grid(P / tile_a, parts);
  if (tile_a == 128)
    return launch_mma(mma::contrastive_pass2_mma_kernel<8>, grid, 256, t,
                      tile_a, stream, (const float*)neg, (float*)s, (float*)g);
  return launch_mma(mma::contrastive_pass2_mma_kernel<16>, grid, 512, t,
                    tile_a, stream, (const float*)neg, (float*)s, (float*)g);
}

// The backward on the tensor cores. da: float32 (parts, P, D), one partial
// dA per part of the walk over M; neg, g, coef float32 (P,). tile_a: 128
// (8 warps; the dA slice leaves no registers for more). D = 256, the model's
// width, takes the instantiation that knows it when compiled unless
// known_depth is 0 (a measurement of the general code).
extern "C" int ucd_contrastive_bwd_mma(
    const void* af, const void* ap, const void* cf, const void* cp,
    const void* la, const void* av, const void* an, const void* lc,
    const void* cv, const void* cn, const void* neg, const void* g,
    const void* coef, void* da, int P, int M, int D, int C, float tau,
    int parts, int stages, int tile_a, int known_depth, void* stream) {
  if (tile_a != 128 || C < 1) return (int)cudaErrorInvalidValue;
  const mma::Operands t = mma_operands(af, ap, cf, cp, la, av, an, lc, cv, cn,
                                       P, M, D, C, tau, parts, stages, tile_a);
  const int slices = (D + mma::DB - 1) / mma::DB;
  if (!t.stages || slices > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(P / tile_a, parts, slices);
  if (D == mma::DB && known_depth)
    return launch_mma(mma::contrastive_bwd_mma_kernel<8, mma::DB / 16>, grid,
                      256, t, tile_a, stream, (const float*)neg,
                      (const float*)g, (const float*)coef, (float*)da);
  return launch_mma(mma::contrastive_bwd_mma_kernel<8, 0>, grid, 256, t,
                    tile_a, stream, (const float*)neg, (const float*)g,
                    (const float*)coef, (float*)da);
}
