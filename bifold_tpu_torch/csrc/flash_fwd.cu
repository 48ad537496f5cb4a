// Flash attention forward for Hopper (sm_90a), plain C ABI: two instances.
//
// - `bifold_flash_fwd_infer` replaces the Pallas TPU kernel
//   `_fwd_kernel_infer` with its loop `_online_softmax_loop`
//   (bifold_tpu/ops/flash_attention.py:187-256): the lse-free forward that
//   serving runs in every SigLIP vision layer (4 frames x 12 heads, n 576,
//   d 64, no mask) and every fusion layer (16 heads, n 2373, d 48, key mask
//   over the context frames).
// - `bifold_flash_fwd_lse` replaces `_fwd_kernel` (:241-247): the same
//   forward that also writes the f32 row logsumexp lse = m + log(max(l,
//   1e-30)), (B, H, Nq) contiguous, which the backward (flash_bwd.cu)
//   recomputes the probabilities from. Training runs it at the same shapes
//   with B=2 (fusion) and B*(T+1)=8 frames (vision). An all-masked row has
//   m = -1e5 and l = nk, so its lse is -1e5 + log(nk).
//
// Semantics, held against `flash_attention_plain` /
// `flash_attention_fwd_plain` in bifold_tpu_torch/ops/flash_attention.py:
//   - q, k, v in the JAX layout (B, N, H, D), read through their strides
//     (the fused to_qkv split arrives as strided views, never copied);
//   - q is scaled in f32; scores, the running max m, the normalizer l and
//     the accumulator are f32 whatever the input type;
//   - a key with mask 0 has its score REPLACED by -1e5 (not -inf), so a row
//     whose keys are all masked averages v uniformly, as the XLA path does;
//   - only the true nk keys are visited, so no padded column ever carries
//     probability mass;
//   - the output is written in the input type, (B, Nq, H, D) contiguous.
//
// What bounds it on this card: at the fusion shape one call is ~17 GFLOP
// per batch row on ~15 MB, far above the H100's ~295 FLOP/byte ridge, so
// the bound is the tensor-core rate (the lse store adds 4 bytes a row). This
// first version does NOT reach it: it runs on the FP32 CUDA cores (FMA), one
// query row per thread. What the design does about the bytes: K/V tiles are
// staged once per block in shared memory and read back as broadcast float4
// loads by every row of the block, so global traffic per block is one pass
// over K/V and no score tile ever leaves registers; m and l already live in
// registers, so the lse costs one f32 store per row. Moving both products
// onto wgmma with TMA-fed K/V tiles is the follow-up that attacks the
// operation bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block, one per thread
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax update
constexpr float kMaskFill = -100000.0f;  // the XLA backend's fill value

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

template <typename T, int D, bool kWithLse>
__global__ void __launch_bounds__(kBlockQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
    int nq, int nk, int h,
    int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn,
    int64_t k_sh, int64_t v_sb, int64_t v_sn, int64_t v_sh, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];
  __shared__ int ms[kBlockK];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < nq;

  float qr[D];
  float acc[D];
  if (active) {
    const T* qp = q + b * q_sb + (int64_t)row * q_sn + head * q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = load_f32(qp + d) * scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = k + b * k_sb + head * k_sh;
  const T* vb = v + b * v_sb + head * v_sh;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    const int tile = min(kBlockK, nk - k0);
    __syncthreads();  // every row is done with the previous tile
    for (int i = threadIdx.x; i < tile * D; i += kBlockQ) {
      const int r = i / D;
      const int c = i - r * D;
      ks[r][c] = load_f32(kb + (int64_t)(k0 + r) * k_sn + c);
      vs[r][c] = load_f32(vb + (int64_t)(k0 + r) * v_sn + c);
    }
    for (int i = threadIdx.x; i < tile; i += kBlockQ)
      ms[i] = mb == nullptr ? 1 : mb[k0 + i];
    __syncthreads();
    if (!active) continue;

    for (int c0 = 0; c0 < tile; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kk = c0 + j;
        if (kk < tile) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(&ks[kk][d]);
            dot = fmaf(qr[d], kv.x, dot);
            dot = fmaf(qr[d + 1], kv.y, dot);
            dot = fmaf(qr[d + 2], kv.z, dot);
            dot = fmaf(qr[d + 3], kv.w, dot);
          }
          s[j] = ms[kk] == 0 ? kMaskFill : dot;
        } else {
          s[j] = -INFINITY;  // past the tile: exactly zero mass below
        }
        cmax = fmaxf(cmax, s[j]);
      }
      // cmax is finite: key c0 < tile always exists
      const float m_new = fmaxf(m, cmax);
      const float alpha = __expf(m - m_new);  // m == -inf on the first chunk -> 0
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < tile) {
          const float p = __expf(s[j] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 vv =
                *reinterpret_cast<const float4*>(&vs[c0 + j][d]);
            acc[d] = fmaf(p, vv.x, acc[d]);
            acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
            acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
            acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* op = o + (((int64_t)b * nq + row) * h + head) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = store_cast<T>(acc[d] / l_safe);
    if (kWithLse) lse[(int64_t)bh * nq + row] = m + logf(l_safe);
  }
}

template <typename T, int D, bool kWithLse>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, void* o, float* lse, int b, int nq,
                   int nk, int h, const int64_t* strides, float scale,
                   cudaStream_t stream) {
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, b * h);
  flash_fwd_kernel<T, D, kWithLse><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, nq, nk, h,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], scale);
  return cudaGetLastError();
}

template <bool kWithLse>
int dispatch(const void* q, const void* k, const void* v, const int* mask,
             void* o, float* lse, int b, int nq, int nk, int h, int d,
             const int64_t* strides, float scale, int dtype, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || h <= 0 || b * h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 48)
    return launch<__nv_bfloat16, 48, kWithLse>(q, k, v, mask, o, lse, b, nq,
                                               nk, h, strides, scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64, kWithLse>(q, k, v, mask, o, lse, b, nq,
                                               nk, h, strides, scale, s);
  if (dtype == 0 && d == 48)
    return launch<float, 48, kWithLse>(q, k, v, mask, o, lse, b, nq, nk, h,
                                       strides, scale, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64, kWithLse>(q, k, v, mask, o, lse, b, nq, nk, h,
                                       strides, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: element strides of q, k, v over
// (batch, token, head), nine values; the head dim is contiguous. mask is
// int32 (B, nk) contiguous, or null for no mask. Returns a cudaError_t.
int bifold_flash_fwd_infer(const void* q, const void* k, const void* v,
                           const int* mask, void* o, int b, int nq, int nk,
                           int h, int d, const int64_t* strides, float scale,
                           int dtype, void* stream) {
  return dispatch<false>(q, k, v, mask, o, nullptr, b, nq, nk, h, d, strides,
                         scale, dtype, stream);
}

// As bifold_flash_fwd_infer, and writes lse: float32 (B, H, Nq) contiguous.
int bifold_flash_fwd_lse(const void* q, const void* k, const void* v,
                         const int* mask, void* o, float* lse, int b, int nq,
                         int nk, int h, int d, const int64_t* strides,
                         float scale, int dtype, void* stream) {
  if (lse == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, mask, o, lse, b, nq, nk, h, d, strides,
                        scale, dtype, stream);
}

const char* bifold_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
