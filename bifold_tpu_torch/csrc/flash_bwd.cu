// Flash attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel `_dqkv_kernel` (bifold_tpu/ops/
// flash_attention.py:360-463, launched by `_backward` :466-543): from q, k,
// v, the key mask, dO, the forward's f32 row logsumexp lse and delta =
// rowsum(dO * O) (f32, computed outside, as JAX does at :499-502) it
// recomputes, per (batch, head) and query row i, key j:
//
//   s    = (q_i . k_j) * scale, in f32, REPLACED by -1e5 where mask_j = 0
//   p    = exp(s - lse_i)
//   dp   = dO_i . v_j
//   ds   = p * (dp - delta_i) * scale, and 0 where mask_j = 0
//   dv_j = sum_i p * dO_i     dk_j = sum_i ds * q_i     dq_i = sum_j ds * k_j
//
// all accumulated in f32 and written once in the input type. ds is 0 on
// user-masked columns, so dq and dk are exactly 0 on a row whose keys are
// all masked, while dv still receives that row's uniform 1/nk mass, as the
// XLA path gives. Only the true nq rows and nk keys are visited, so no
// padded row or column carries mass at a ragged n.
//
// Training runs it in every fusion layer (B=2 x 16 heads, n 2373, d 48, key
// mask over the context frames) and every SigLIP vision layer (8 frames x
// 12 heads, n 576, d 64, no mask).
//
// Design. The TPU kernel walks the q blocks of one (b*h) row in sequence and
// keeps full-row f32 dk/dv blocks resident in VMEM across them. On Hopper
// blocks run in any order and a block has at most 227 KB of shared memory,
// so that does not transfer. Instead, route (a) of the two usual ones:
//
//   1. `dkdv_kernel`, kv-block-major: a block owns 64 keys and keeps their
//      k, v and the f32 dk, dv accumulators in registers, while it streams
//      q, dO, lse and delta through shared memory in 64-row tiles. Each key
//      sees every query row inside one block, so dk and dv are complete when
//      the block ends and are written once: no atomics, no f32 scratch.
//   2. `dq_kernel`, q-block-major: a block owns 64 query rows (q, dO, dq in
//      registers), streams k, v and the mask, and recomputes p and dp.
//
// Route (a) was taken over f32 atomicAdd into a (B, Nq, H, d) buffer
// because it is deterministic (the sum order does not depend on block
// scheduling), needs no scratch or zeroing pass, and is the simplest to
// hold exactly against the plain version. Its price is the recompute: 7
// d-long dot products or updates per (i, j) pair instead of 5.
//
// Layout: each row (a key in kernel 1, a query in kernel 2) is owned by TWO
// adjacent threads, each holding one half of the head dim, with the two
// partial dot products summed by one warp shuffle. That keeps the register
// arrays at 2d floats (kernel 1) and 1.5d floats (kernel 2) per thread, so
// d 64 compiles without spills, and it is indifferent to d=48 not being a
// multiple of 32 lanes. Shared-memory rows store the second half at a
// 16-byte-aligned offset whose bank differs from the first half's, so the
// two broadcast float4 loads of a warp never conflict.
//
// What bounds it on this card: at the fusion shape one call is ~43 GFLOP per
// batch row (5 products at 2 FLOP per multiply-add) on ~30 MB of inputs and
// outputs, far above the ~295 FLOP/byte ridge, so the bound is the
// tensor-core rate. This first version runs every product on the FP32 CUDA
// cores (FMA), like the forward; moving them onto mma/wgmma is the follow-up
// that attacks the operation bound. What the design does about the bytes:
// every streamed tile is read from device memory once per block and reused
// by all 64 rows of the block from shared memory, and no (nq, nk) score,
// probability or ds tile ever leaves registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;              // rows a block owns, two threads each
constexpr int kThreads = 2 * kRows;
constexpr int kTile = 64;              // rows per streamed shared-memory tile
constexpr float kMaskFill = -100000.0f;  // the XLA backend's fill value

// Shared-memory row of head dim D: first half at 0, second half at kOff.
template <int D>
struct Row {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int kHalf = D / 2;
  static constexpr int kPad = (kHalf % 32 == 0) ? 4 : 0;  // bank shift
  static constexpr int kOff = kHalf + kPad;
  static constexpr int kLen = D + kPad;
};

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T store_cast(float x);
template <> __device__ __forceinline__ float store_cast<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// rows x D elements from global (row stride in elements, head dim
// contiguous) into f32 shared rows, converted once
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      int64_t row_stride, int rows) {
  using R = Row<D>;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * R::kLen + (c < R::kHalf ? c : c + R::kPad)] =
        load_f32(src + (int64_t)r * row_stride + c);
  }
}

// this thread's half of one head-dim row, from global into registers
template <typename T, int H>
__device__ __forceinline__ void load_half(float* dst, const T* src, bool on) {
#pragma unroll
  for (int c = 0; c < H; ++c) dst[c] = on ? load_f32(src + c) : 0.f;
}

template <typename T, int H>
__device__ __forceinline__ void store_half(T* dst, const float* src) {
#pragma unroll
  for (int c = 0; c < H; ++c) dst[c] = store_cast<T>(src[c]);
}

// full dot product of a row split over the thread pair (t, t ^ 1): the
// partial over this thread's half (registers . shared), summed by a shuffle
template <int H>
__device__ __forceinline__ float pair_dot(const float* reg, const float* sm) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int c = 0; c < H; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(sm + c);
    a = fmaf(reg[c], x.x, a);
    b = fmaf(reg[c + 1], x.y, b);
    a = fmaf(reg[c + 2], x.z, a);
    b = fmaf(reg[c + 3], x.w, b);
  }
  a += b;
  return a + __shfl_xor_sync(0xffffffffu, a, 1);
}

// acc += w * shared row half
template <int H>
__device__ __forceinline__ void axpy(float* acc, float w, const float* sm) {
#pragma unroll
  for (int c = 0; c < H; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(sm + c);
    acc[c] = fmaf(w, x.x, acc[c]);
    acc[c + 1] = fmaf(w, x.y, acc[c + 1]);
    acc[c + 2] = fmaf(w, x.z, acc[c + 2]);
    acc[c + 3] = fmaf(w, x.w, acc[c + 3]);
  }
}

struct Strides {  // element strides over (batch, token, head); D contiguous
  int64_t q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h;
};

// dO is (B, Nq, H, D) contiguous; lse and delta (B, H, Nq) f32 contiguous;
// dk and dv are written (B, Nk, H, D) contiguous in T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int nq, int nk, int h, Strides st,
    float scale) {
  using R = Row<D>;
  constexpr int H = R::kHalf;
  __shared__ __align__(16) float qs[kTile * R::kLen];
  __shared__ __align__(16) float dos[kTile * R::kLen];
  __shared__ float lses[kTile];
  __shared__ float deltas[kTile];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int half = threadIdx.x & 1;
  const int key = blockIdx.x * kRows + (threadIdx.x >> 1);
  const bool active = key < nk;   // both threads of a pair agree
  const bool kept =
      !active || mask == nullptr || mask[(int64_t)b * nk + key] != 0;

  float kr[H], vr[H], dkr[H], dvr[H];
  load_half<T, H>(kr, k + b * st.k_b + (int64_t)key * st.k_n + head * st.k_h
                          + half * H, active);
  load_half<T, H>(vr, v + b * st.v_b + (int64_t)key * st.v_n + head * st.v_h
                          + half * H, active);
#pragma unroll
  for (int c = 0; c < H; ++c) dkr[c] = dvr[c] = 0.f;

  const T* qb = q + b * st.q_b + head * st.q_h;
  const int64_t o_n = (int64_t)h * D;               // dO row stride
  const T* ob = dout + ((int64_t)b * nq * h + head) * D;
  const float* lb = lse + (int64_t)bh * nq;
  const float* db = delta + (int64_t)bh * nq;
  const int off = half * R::kOff;

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    const int tile = min(kTile, nq - q0);
    __syncthreads();  // every pair is done with the previous tile
    stage<T, D>(qs, qb + (int64_t)q0 * st.q_n, st.q_n, tile);
    stage<T, D>(dos, ob + (int64_t)q0 * o_n, o_n, tile);
    for (int i = threadIdx.x; i < tile; i += kThreads) {
      lses[i] = lb[q0 + i];
      deltas[i] = db[q0 + i];
    }
    __syncthreads();
    // every thread runs the loop (the shuffles need the whole warp);
    // a pair past nk computes on zeros and stores nothing
    for (int i = 0; i < tile; ++i) {
      const float* qi = qs + i * R::kLen + off;
      const float* oi = dos + i * R::kLen + off;
      const float qk = pair_dot<H>(kr, qi);   // shuffles: never skipped
      const float dp = pair_dot<H>(vr, oi);
      const float s = kept ? qk * scale : kMaskFill;
      const float p = active ? __expf(s - lses[i]) : 0.f;
      const float ds = kept ? p * (dp - deltas[i]) * scale : 0.f;
      axpy<H>(dvr, p, oi);
      axpy<H>(dkr, ds, qi);
    }
  }

  if (active) {
    const int64_t at = (((int64_t)b * nk + key) * h + head) * D + half * H;
    store_half<T, H>(dk + at, dkr);
    store_half<T, H>(dv + at, dvr);
  }
}

// dq is written (B, Nq, H, D) contiguous in T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int nq, int nk, int h, Strides st, float scale) {
  using R = Row<D>;
  constexpr int H = R::kHalf;
  __shared__ __align__(16) float ks[kTile * R::kLen];
  __shared__ __align__(16) float vs[kTile * R::kLen];
  __shared__ int ms[kTile];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 1);
  const bool active = row < nq;   // both threads of a pair agree

  float qr[H], dor[H], dqr[H];
  load_half<T, H>(qr, q + b * st.q_b + (int64_t)row * st.q_n + head * st.q_h
                          + half * H, active);
  load_half<T, H>(dor, dout + (((int64_t)b * nq + row) * h + head) * D
                           + half * H, active);
#pragma unroll
  for (int c = 0; c < H; ++c) dqr[c] = 0.f;
  const float l = active ? lse[(int64_t)bh * nq + row] : 0.f;
  const float dl = active ? delta[(int64_t)bh * nq + row] : 0.f;

  const T* kb = k + b * st.k_b + head * st.k_h;
  const T* vb = v + b * st.v_b + head * st.v_h;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;
  const int off = half * R::kOff;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    const int tile = min(kTile, nk - k0);
    __syncthreads();  // every pair is done with the previous tile
    stage<T, D>(ks, kb + (int64_t)k0 * st.k_n, st.k_n, tile);
    stage<T, D>(vs, vb + (int64_t)k0 * st.v_n, st.v_n, tile);
    for (int i = threadIdx.x; i < tile; i += kThreads)
      ms[i] = mb == nullptr ? 1 : mb[k0 + i];
    __syncthreads();
    for (int j = 0; j < tile; ++j) {
      if (ms[j] == 0) continue;   // ds = 0: the same for the whole block
      const float* kj = ks + j * R::kLen + off;
      const float s = pair_dot<H>(qr, kj) * scale;
      const float dp = pair_dot<H>(dor, vs + j * R::kLen + off);
      const float ds = active ? __expf(s - l) * (dp - dl) * scale : 0.f;
      axpy<H>(dqr, ds, kj);
    }
  }

  if (active)
    store_half<T, H>(dq + (((int64_t)b * nq + row) * h + head) * D + half * H,
                     dqr);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, int b,
                   int nq, int nk, int h, const Strides& st, float scale,
                   cudaStream_t stream) {
  const dim3 grid_kv((nk + kRows - 1) / kRows, b * h);
  dkdv_kernel<T, D><<<grid_kv, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), nq, nk, h, st, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((nq + kRows - 1) / kRows, b * h);
  dq_kernel<T, D><<<grid_q, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), nq, nk, h, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv alike).
// strides: element strides of q, k, v over (batch, token, head), nine
// values; the head dim is contiguous. dout is (B, Nq, H, D) contiguous, lse
// and delta float32 (B, H, Nq) contiguous, mask int32 (B, nk) contiguous or
// null. dq, dk, dv are written contiguous in the JAX layout. Launches the
// dk/dv kernel, then the dq kernel, on `stream`; returns a cudaError_t.
int bifold_flash_bwd(const void* q, const void* k, const void* v,
                     const int* mask, const void* dout, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, int b,
                     int nq, int nk, int h, int d, const int64_t* strides,
                     float scale, int dtype, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || h <= 0 || b * h > 65535 ||
      lse == nullptr || delta == nullptr)
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 48)
    return launch<__nv_bfloat16, 48>(q, k, v, mask, dout, lse, delta, dq, dk,
                                     dv, b, nq, nk, h, st, scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, mask, dout, lse, delta, dq, dk,
                                     dv, b, nq, nk, h, st, scale, s);
  if (dtype == 0 && d == 48)
    return launch<float, 48>(q, k, v, mask, dout, lse, delta, dq, dk, dv, b,
                             nq, nk, h, st, scale, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, mask, dout, lse, delta, dq, dk, dv, b,
                             nq, nk, h, st, scale, s);
  return cudaErrorInvalidValue;
}

const char* bifold_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
