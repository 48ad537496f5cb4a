// LayerNorm for Hopper (sm_90a), plain C ABI: four entry points.
//
// - `bifold_ln_fwd` replaces the Pallas TPU kernel `_fwd_kernel`
//   (bifold_tpu/ops/layer_norm.py:141, launched by `ln_forward` :156): a row
//   LayerNorm over the last dim -> out in x's type, and the f32 row mean and
//   rstd that the backward reads.
// - `bifold_ln_bwd` replaces `_bwd_kernel` (:199, launched by `ln_backward`
//   :223): dx per row, and dscale, dbias summed over every row in f32.
// - `bifold_fused_ln_fwd` replaces `_fused_fwd_kernel` (:271, launched by
//   `fused_ln_forward` :291): s = x + delta, rounded to x's type and stored,
//   then the LayerNorm of that ROUNDED s (so the fused stack matches the
//   unfused one, which adds in the stream type and then normalizes).
// - `bifold_fused_ln_bwd` replaces `_fused_bwd_kernel` (:322, launched by
//   `fused_ln_backward` :344): as `bifold_ln_bwd` on s, with the residual
//   stream's cotangent ds_out added to dx before it is stored.
//
// Semantics, held against the plain versions in
// bifold_tpu_torch/ops/layer_norm.py:
//   - statistics in f32 with the FAST variance E[x^2] - E[x]^2 clamped at 0,
//     as the TPU kernel and flax compute it (Welford or two passes would
//     differ on rows with a large mean); rstd = 1 / sqrt(var + eps), eps an
//     argument (1e-6 in the SigLIP towers, 1e-5 in the fusion stack);
//   - y = (x - mean) * rstd * scale + bias in f32, stored in x's type; scale
//     and bias are read as f32 whether they are stored in f32 or bf16;
//   - dxhat = dy * scale, dx = rstd * (dxhat - mean(dxhat)
//     - xhat * mean(dxhat * xhat)), all in f32;
//   - rows (x, delta, dy, ds_out, s, out, dx) are float32 or bfloat16, all of
//     one type, contiguous (R, C) with 16-byte aligned bases; C is a multiple
//     of 128 up to 1024; any R >= 1 runs, with no padding.
//
// Layout. One warp owns one row. A lane owns chunks of 8 consecutive
// columns, chunk j going to lane j % 32: a bf16 chunk is one 16-byte load,
// an f32 chunk two, and a warp's loads of one chunk index cover one
// contiguous span of the row. 768 columns are 96 chunks, 3 per lane; the
// number of chunks a lane holds is a template parameter, so the row lives in
// registers and is read from device memory once. The row sums are reduced by
// an xor-butterfly of warp shuffles, which leaves the same bits in every
// lane. The TPU's 256-row padding is gone: a warp past R stores nothing.
//
// dscale and dbias. The TPU sums them in one VMEM block carried across a
// sequential grid; Hopper's blocks run in no order. Here a backward block's
// warps walk rows with a grid stride and keep per-lane f32 partial sums of
// their columns in registers; the block adds its warps' partials in shared
// memory in warp order and writes one (2, C) row of an f32 scratch; a second
// kernel sums the scratch rows of each column in a fixed order. No atomics:
// two calls on the same inputs give bitwise equal dscale and dbias.
//
// What bounds it on this card: bytes. A forward call at the flagship's
// largest shape (4746 x 768 bf16) reads 7.3 MB and writes 7.3 MB (~4.4 us at
// 3.35 TB/s) and does ~10 FLOP per element, far below the ~295 FLOP/byte
// ridge. At these sizes a call is a few microseconds, so the launch and the
// host's enqueue cost as much as the bytes; what the kernels save on this
// card is mostly the ~14 elementwise and reduction launches of the eager
// LayerNorm they replace (and its f32 intermediates). The design moves each
// row once each way, with 16-byte loads, and keeps the scratch small: at
// most `partial_rows` (2, C) rows, whatever R is.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                  // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;                    // columns per chunk
constexpr int kMaxSlots = 4;               // chunks per lane
constexpr int kMaxCols = 32 * kVec * kMaxSlots;   // 1024
constexpr int kColTile = 32;               // column-sum kernel: columns ...
constexpr int kColSplit = 8;               // ... and scratch-row groups

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// scale or bias, stored as f32 or bf16, read as f32
__device__ __forceinline__ void load8_param(const void* p, int bf16, int col,
                                            float v[kVec]) {
  if (bf16)
    load8(static_cast<const __nv_bfloat16*>(p) + col, v);
  else
    load8(static_cast<const float*>(p) + col, v);
}

// round an f32 value to T and back (the stream type's rounding of s)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// butterfly: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int S, bool kFused>
__global__ void __launch_bounds__(kThreads) ln_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ delta,
    const void* __restrict__ scale, const void* __restrict__ bias,
    int param_bf16, T* __restrict__ s_out, T* __restrict__ out,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
    int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int chunks = cols / kVec;
  const int64_t base = static_cast<int64_t>(row) * cols;

  float v[S][kVec];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int chunk = i * 32 + lane;
    if (chunk < chunks) {
      const int64_t at = base + chunk * kVec;
      load8(x + at, v[i]);
      if constexpr (kFused) {
        float d[kVec];
        load8(delta + at, d);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[i][e] = round_to<T>(v[i][e] + d[e]);
        store8(s_out + at, v[i]);  // exact: v already holds T values
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sum += v[i][e];
        sumsq += v[i][e] * v[i][e];
      }
    }
  }
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  const float mean = sum / cols;
  const float var = fmaxf(sumsq / cols - mean * mean, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int chunk = i * 32 + lane;
    if (chunk < chunks) {
      float sc[kVec], bi[kVec], y[kVec];
      load8_param(scale, param_bf16, chunk * kVec, sc);
      load8_param(bias, param_bf16, chunk * kVec, bi);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        y[e] = (v[i][e] - mean) * rstd * sc[e] + bi[e];
      store8(out + base + chunk * kVec, y);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int S, bool kFused>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const T* __restrict__ ds_out, const float* __restrict__ mean,
    const float* __restrict__ rstd, const void* __restrict__ scale,
    int param_bf16, T* __restrict__ dx, float* __restrict__ partial, int rows,
    int cols) {
  __shared__ float red[2 * kMaxCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = cols / kVec;

  float sc[S][kVec], dsc[S][kVec], dbi[S][kVec];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int chunk = i * 32 + lane;
    if (chunk < chunks) load8_param(scale, param_bf16, chunk * kVec, sc[i]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dsc[i][e] = dbi[i][e] = 0.f;
  }

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const int64_t base = static_cast<int64_t>(row) * cols;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[S][kVec], g[S][kVec];
    float sum1 = 0.f, sum2 = 0.f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int chunk = i * 32 + lane;
      if (chunk < chunks) {
        load8(x + base + chunk * kVec, xh[i]);
        load8(dy + base + chunk * kVec, g[i]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          xh[i][e] = (xh[i][e] - mu) * rs;
          dsc[i][e] += g[i][e] * xh[i][e];
          dbi[i][e] += g[i][e];
          g[i][e] *= sc[i][e];  // dxhat
          sum1 += g[i][e];
          sum2 += g[i][e] * xh[i][e];
        }
      }
    }
    const float m1 = warp_sum(sum1) / cols;
    const float m2 = warp_sum(sum2) / cols;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int chunk = i * 32 + lane;
      if (chunk < chunks) {
        float d[kVec];
        if constexpr (kFused) load8(ds_out + base + chunk * kVec, d);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float v = rs * (g[i][e] - m1 - xh[i][e] * m2);
          if constexpr (kFused)
            d[e] += v;  // the residual stream's cotangent folded in
          else
            d[e] = v;
        }
        store8(dx + base + chunk * kVec, d);
      }
    }
  }

  // the block's partial sums, its warps added in order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int chunk = i * 32 + lane;
        if (chunk < chunks) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int c = chunk * kVec + e;
            red[c] = w == 0 ? dsc[i][e] : red[c] + dsc[i][e];
            red[cols + c] = w == 0 ? dbi[i][e] : red[cols + c] + dbi[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* dst = partial + static_cast<int64_t>(blockIdx.x) * 2 * cols;
  for (int c = threadIdx.x; c < 2 * cols; c += kThreads) dst[c] = red[c];
}

// dscale | dbias from the (nparts, 2 * cols) scratch: each column summed in
// a fixed order (kColSplit strided groups, then the groups in order)
__global__ void __launch_bounds__(kColTile * kColSplit) col_sum_kernel(
    const float* __restrict__ partial, int nparts, int cols,
    float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float acc[kColSplit][kColTile];
  const int width = 2 * cols;
  const int col = blockIdx.x * kColTile + threadIdx.x;
  float sum = 0.f;
  if (col < width)
    for (int p = threadIdx.y; p < nparts; p += kColSplit)
      sum += partial[static_cast<int64_t>(p) * width + col];
  acc[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kColSplit; ++j) total += acc[j][threadIdx.x];
    if (col < cols)
      dscale[col] = total;
    else
      dbias[col - cols] = total;
  }
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

bool bad_shape(int rows, int cols, int dtype, int param_dtype) {
  return rows <= 0 || cols <= 0 || cols % 128 != 0 || cols > kMaxCols ||
         (dtype != 0 && dtype != 1) || (param_dtype != 0 && param_dtype != 1);
}

template <typename T, int S, bool kFused>
cudaError_t fwd_launch(const void* x, const void* delta, const void* scale,
                       const void* bias, int param_bf16, void* s, void* out,
                       float* mean, float* rstd, int rows, int cols,
                       float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<T, S, kFused><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), scale, bias,
      param_bf16, static_cast<T*>(s), static_cast<T*>(out), mean, rstd, rows,
      cols, eps);
  return cudaGetLastError();
}

template <bool kFused>
int fwd_dispatch(const void* x, const void* delta, const void* scale,
                 const void* bias, void* s, void* out, float* mean,
                 float* rstd, int rows, int cols, float eps, int dtype,
                 int param_dtype, void* stream) {
  if (bad_shape(rows, cols, dtype, param_dtype) || misaligned(x) ||
      misaligned(out) || misaligned(scale) || misaligned(bias) ||
      (kFused && (misaligned(delta) || misaligned(s))))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = (cols / kVec + 31) / 32;
#define BIFOLD_LN_FWD(T, S)                                                  \
  return fwd_launch<T, S, kFused>(x, delta, scale, bias, param_dtype, s, out, \
                                  mean, rstd, rows, cols, eps, st)
#define BIFOLD_LN_FWD_SLOTS(T)      \
  switch (slots) {                  \
    case 1: BIFOLD_LN_FWD(T, 1);    \
    case 2: BIFOLD_LN_FWD(T, 2);    \
    case 3: BIFOLD_LN_FWD(T, 3);    \
    default: BIFOLD_LN_FWD(T, 4);   \
  }
  if (dtype == 1) {
    BIFOLD_LN_FWD_SLOTS(__nv_bfloat16)
  }
  BIFOLD_LN_FWD_SLOTS(float)
#undef BIFOLD_LN_FWD_SLOTS
#undef BIFOLD_LN_FWD
}

template <typename T, int S, bool kFused>
cudaError_t bwd_launch(const void* x, const void* dy, const void* ds_out,
                       const float* mean, const float* rstd,
                       const void* scale, int param_bf16, void* dx,
                       float* partial, int blocks, int rows, int cols,
                       cudaStream_t stream) {
  ln_bwd_kernel<T, S, kFused><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(ds_out), mean, rstd, scale, param_bf16,
      static_cast<T*>(dx), partial, rows, cols);
  return cudaGetLastError();
}

template <bool kFused>
int bwd_dispatch(const void* x, const void* dy, const void* ds_out,
                 const float* mean, const float* rstd, const void* scale,
                 void* dx, float* partial, float* dscale, float* dbias,
                 int rows, int cols, int partial_rows, int dtype,
                 int param_dtype, void* stream) {
  if (bad_shape(rows, cols, dtype, param_dtype) || partial_rows <= 0 ||
      partial == nullptr || misaligned(x) || misaligned(dy) ||
      misaligned(dx) || misaligned(scale) || (kFused && misaligned(ds_out)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = (cols / kVec + 31) / 32;
  const int needed = (rows + kWarps - 1) / kWarps;
  const int blocks = needed < partial_rows ? needed : partial_rows;
  cudaError_t err;
#define BIFOLD_LN_BWD(T, S)                                               \
  err = bwd_launch<T, S, kFused>(x, dy, ds_out, mean, rstd, scale,        \
                                 param_dtype, dx, partial, blocks, rows,  \
                                 cols, st);                               \
  break
#define BIFOLD_LN_BWD_SLOTS(T)      \
  switch (slots) {                  \
    case 1: BIFOLD_LN_BWD(T, 1);    \
    case 2: BIFOLD_LN_BWD(T, 2);    \
    case 3: BIFOLD_LN_BWD(T, 3);    \
    default: BIFOLD_LN_BWD(T, 4);   \
  }
  if (dtype == 1) {
    BIFOLD_LN_BWD_SLOTS(__nv_bfloat16)
  } else {
    BIFOLD_LN_BWD_SLOTS(float)
  }
#undef BIFOLD_LN_BWD_SLOTS
#undef BIFOLD_LN_BWD
  if (err != cudaSuccess) return err;
  const dim3 col_block(kColTile, kColSplit);
  col_sum_kernel<<<(2 * cols + kColTile - 1) / kColTile, col_block, 0, st>>>(
      partial, blocks, cols, dscale, dbias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (x, delta, s, out, dy, ds_out, dx): 0 = float32, 1 = bfloat16;
// param_dtype (scale, bias) likewise. Rows are contiguous (rows, cols) with
// 16-byte aligned bases; mean and rstd are float32 (rows,). Each returns a
// cudaError_t.
int bifold_ln_fwd(const void* x, const void* scale, const void* bias,
                  void* out, float* mean, float* rstd, int rows, int cols,
                  float eps, int dtype, int param_dtype, void* stream) {
  return fwd_dispatch<false>(x, nullptr, scale, bias, nullptr, out, mean,
                             rstd, rows, cols, eps, dtype, param_dtype,
                             stream);
}

int bifold_fused_ln_fwd(const void* x, const void* delta, const void* scale,
                        const void* bias, void* s, void* out, float* mean,
                        float* rstd, int rows, int cols, float eps, int dtype,
                        int param_dtype, void* stream) {
  return fwd_dispatch<true>(x, delta, scale, bias, s, out, mean, rstd, rows,
                            cols, eps, dtype, param_dtype, stream);
}

// partial: float32 scratch of partial_rows x 2 x cols; the backward runs
// min(ceil(rows / 4), partial_rows) blocks, each writing one scratch row.
// dscale and dbias: float32 (cols,).
int bifold_ln_bwd(const void* x, const void* dy, const float* mean,
                  const float* rstd, const void* scale, void* dx,
                  float* partial, float* dscale, float* dbias, int rows,
                  int cols, int partial_rows, int dtype, int param_dtype,
                  void* stream) {
  return bwd_dispatch<false>(x, dy, nullptr, mean, rstd, scale, dx, partial,
                             dscale, dbias, rows, cols, partial_rows, dtype,
                             param_dtype, stream);
}

int bifold_fused_ln_bwd(const void* s, const void* dy, const void* ds_out,
                        const float* mean, const float* rstd,
                        const void* scale, void* dx, float* partial,
                        float* dscale, float* dbias, int rows, int cols,
                        int partial_rows, int dtype, int param_dtype,
                        void* stream) {
  return bwd_dispatch<true>(s, dy, ds_out, mean, rstd, scale, dx, partial,
                            dscale, dbias, rows, cols, partial_rows, dtype,
                            param_dtype, stream);
}

const char* bifold_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
