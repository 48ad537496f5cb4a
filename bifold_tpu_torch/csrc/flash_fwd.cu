// Flash attention forward for Hopper (sm_90a), plain C ABI: two entry
// points, each instanced at head dims 32, 48 and 64.
//
// - `bifold_flash_fwd_infer` replaces the Pallas TPU kernel
//   `_fwd_kernel_infer` with its loop `_online_softmax_loop`
//   (bifold_tpu/ops/flash_attention.py:187-256): the lse-free forward that
//   serving runs in every SigLIP vision layer (4 frames x 12 heads, n 576,
//   d 64, no mask), every flagship fusion layer (16 heads, n 2373, d 48,
//   key mask over the context frames) and every rgb_clip fusion layer (16
//   heads of 512, n 275 = 78 text + 197 image tokens, d 32, no mask).
// - `bifold_flash_fwd_lse` replaces `_fwd_kernel` (:241-247): the same
//   forward that also writes the f32 row logsumexp lse = m + log(max(l,
//   1e-30)), (B, H, Nq) contiguous, which the backward (flash_bwd.cu)
//   recomputes the probabilities from. Training runs it at the same shapes
//   with B=2 (fusion, both families) and B*(T+1)=8 frames (vision). An
//   all-masked row has
//   m = -1e5 and l = nk, so its lse is -1e5 + log(nk).
//
// Semantics, held against `flash_attention_plain` /
// `flash_attention_fwd_plain` in bifold_tpu_torch/ops/flash_attention.py:
//   - q, k, v in the JAX layout (B, N, H, D), read through their strides
//     (the fused to_qkv split arrives as strided views, never copied);
//   - scores, the running max m, the normalizer l and the accumulator are
//     f32 whatever the input type;
//   - a key with mask 0 has its score REPLACED by -1e5 (not -inf), so a row
//     whose keys are all masked averages v uniformly, as the XLA path does;
//   - keys past the true nk carry no probability mass;
//   - the output is written in the input type, (B, Nq, H, D) contiguous.
//
// What bounds it on this card: at the fusion shape one call is ~17 GFLOP
// per batch row on ~15 MB, far above the H100's ~295 FLOP/byte ridge, so
// the bound is the tensor-core rate: 0.0175 ms for the batch-1 fusion call,
// 0.0042 ms (bytes) for the 4-frame vision call.
//
// bf16 (the flagship): `flash_fwd_mma`, both products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators; mma_bf16.cuh).
//   - A block of 4 warps owns 64 query rows, 16 per warp. The Q tile is
//     copied once into shared memory and read into A fragments that stay in
//     registers for the whole key loop.
//   - K/V come in 64-key tiles (and the key mask beside them) by 16-byte
//     cp.async into a 2-stage ring of padded bf16 rows (D + 8 elements), so
//     the copy of tile j + 1 overlaps the products of tile j. Rows past n
//     are zero-filled: no garbage (NaN) ever enters a product.
//   - S = Q.K^T is scaled in f32 after the product (scale * log2 e folded
//     in, so exp2f gives the softmax), masked, and run through the online
//     softmax per row; the four lanes of a quad that share a row meet by
//     __shfl_xor 1 and 2. P then feeds P.V as the A operand straight from
//     the accumulator fragments, without a shared-memory round trip.
//   - The epilogue divides by l, writes the output in bf16 and, in the lse
//     instance, the f32 lse.
//   - Four blocks per SM (__launch_bounds__): 127-128 registers, no spills,
//     6-11% faster than the compiler's own 114-131. 128-row blocks (8
//     warps) were faster at two of the four main-path shapes and slower at
//     the other two, so the block stays at 64 rows (PERF.md, PR 4;
//     tools/flash_variants.py measures both).
//   Rounding points beyond the plain version's: P is rounded to bf16 as the
//   A operand of P.V (l sums the f32 P). The JAX kernel keeps P in f32 (its
//   bf16 flags are off by default); the emulation in
//   tests/test_torch_flash_attention.py holds this arithmetic within the
//   bf16 tolerance of the plain version.
//   d = 32 is the same template: QK^T takes two k-steps of m16n8k16, P.V
//   four 8-wide n-tiles; its padded rows are 80 bytes, so the eight 16-byte
//   rows of one ldmatrix start at offsets 0, 80, 160, ... = 0, 80, 32, 112,
//   64, 16, 96, 48 mod 128: eight distinct bank groups, no conflict. At
//   n 275 the last key tile holds 19 keys (the rest zero-filled and masked
//   out), and one request's grid is 5 query tiles x 16 heads = 80 blocks,
//   fewer than the 132 SMs.
//   Left for a later design: wgmma on TMA-fed, swizzled tiles with a
//   producer warp. d=48's 96-byte rows fit no swizzle atom unless padded
//   or split, which is why this version stays on mma.sync.
//
// f32: `flash_fwd_tf32`, the same structure with every product 3xTF32 on
// the tensor cores (mma.sync m16n8k8 tf32; mma_tf32.cuh). The f32
// instances are the card's precision reference (the f32 gradient,
// train-step and action checks hold them at 1e-4), which bf16 or a single
// TF32 pass (about three decimal digits) cannot meet; 3xTF32 keeps f32's
// accuracy at 3 x FLOP / 495 TFLOP/s against FMA's FLOP / 67 TFLOP/s. The
// path is chosen by dtype, not as a fallback.
//   - A block of 4 warps owns 64 query rows, 16 per warp. Q is split into
//     TF32 hi and lo once and held as A fragments for the whole key loop.
//   - K/V come in 32-key tiles by 16-byte cp.async into a 2-stage ring of
//     padded f32 rows (D + 4 floats: every fragment load conflict-free,
//     mma_tf32.cuh); each B value is split as it is loaded. Splitting each
//     tile once into hi and lo rows in shared memory instead (two loads a
//     value, an extra pass and barrier, 69.9 KB at d64) measured 10-23%
//     slower (PERF.md §6).
//   - The online softmax runs in f32 in log2 units, as the bf16 kernel's;
//     P leaves the accumulators as the A operand of P.V with k permuted
//     (acc_as_a) and is split into hi and lo like any other operand, never
//     rounded further.
//   - Three blocks per SM (__launch_bounds__): 127 / 158 / 168 registers at
//     d 32 / 48 / 64, the d64 instances spilling 24 bytes; two blocks per
//     SM (190 registers, no spill) were 0.6% faster at the d64 train shape,
//     8% faster at the d64 serving shape (which no main path runs in f32)
//     and up to 2% slower at d48 (tools/flash_variants.py f32_blocks2).
//   Rounding points beyond the plain version's: the TF32 splits and the
//   dropped lo.lo products (below 2^-21 of each product); the emulation in
//   tests/test_torch_flash_attention.py holds this arithmetic within 1e-5
//   of the plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using bifold::bf16;

constexpr float kMaskFill = -100000.0f;  // the XLA backend's fill value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // element strides over (batch, token, head); D contiguous
  int64_t q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;              // keys per ring stage
constexpr int kBlocksPerSM = 4;        // caps registers at 128 a thread

template <int D, bool kWithLse>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSM) flash_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ mask,
    bf16* __restrict__ o, float* __restrict__ lse, int nq, int nk, int h,
    Strides st, float scale_log2) {
  using namespace bifold;
  constexpr int S = D + 8;  // shared row, padded
  constexpr float kFill2 = kMaskFill * kLog2e;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kMmaRows <= 2 * kKeys, "the Q tile borrows one ring stage");
  // ring stage: K rows, then V rows; the Q tile is staged in stage 1 first
  __shared__ __align__(128) bf16 kv[2][2 * kKeys * S];
  __shared__ int ms[2][kKeys];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.x * kMmaRows;
  const bf16* kb = k + b * st.k_b + head * st.k_h;
  const bf16* vb = v + b * st.v_b + head * st.v_h;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;
  const int tiles = (nk + kKeys - 1) / kKeys;

  load_rows<D, kMmaRows, kMmaThreads>(kv[1], q + b * st.q_b + head * st.q_h,
                                      st.q_n, q0, nq);
  cp_async_commit();
  load_key_tile<D, kKeys, kMmaThreads>(kv[0], ms[0], kb, vb, mb, st.k_n,
                                       st.v_n, 0, nk);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], &kv[1][(warp * 16 + a_row(lane)) * S + kk * 16 +
                               a_col(lane)]);
  __syncthreads();  // every warp holds its Q fragments: stage 1 is free
  if (tiles > 1)
    load_key_tile<D, kKeys, kMmaThreads>(kv[1], ms[1], kb, vb, mb, st.k_n,
                                         st.v_n, kKeys, nk);
  cp_async_commit();

  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const bf16* ks = kv[j & 1];
    const bf16* vs = ks + kKeys * S;
    const int* mk = ms[j & 1];
    const int k0 = j * kKeys;

    float s[kKeys / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, &ks[(np * 16 + b_row(lane)) * S + kk * 16 +
                            b_col(lane)]);
        mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // scale after the product, mask, online softmax (rows g and g + 8)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        const float x = k0 + col >= nk   ? -INFINITY
                        : mk[col] == 0 ? kFill2
                                       : s[n][e] * scale_log2;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key k0 < nk exists; exp2(-inf) = 0 on the first tile
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P.V, P rounded to bf16 from the accumulators
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &vs[(kk * 16 + a_row(lane)) * S + dp * 16 +
                                  a_col(lane)]);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < tiles)
      load_key_tile<D, kKeys, kMmaThreads>(kv[j & 1], ms[j & 1], kb, vb, mb,
                                           st.k_n, st.v_n, (j + 2) * kKeys,
                                           nk);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= nq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    bf16* op = o + (((int64_t)b * nq + row) * h + head) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    if (kWithLse && tq == 0)
      lse[(int64_t)bh * nq + row] = m[r] * kLn2 + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// f32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kKeysF32 = 32;        // keys per ring stage
constexpr int kBlocksPerSMF32 = 3;  // caps registers at 168 a thread

template <int D, bool kWithLse>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSMF32)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ mask,
                   float* __restrict__ o, float* __restrict__ lse, int nq,
                   int nk, int h, Strides st, float scale_log2) {
  using namespace bifold;
  constexpr int S = D + 4;  // shared row, padded
  constexpr int kK = kKeysF32;
  constexpr float kFill2 = kMaskFill * kLog2e;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(kMmaRows <= 2 * kK, "the Q tile borrows one ring stage");
  // ring stage: K rows, then V rows; the Q tile is staged in stage 1 first
  __shared__ __align__(128) float kv[2][2 * kK * S];
  __shared__ int ms[2][kK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.x * kMmaRows;
  const float* kb = k + b * st.k_b + head * st.k_h;
  const float* vb = v + b * st.v_b + head * st.v_h;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;
  const int tiles = (nk + kK - 1) / kK;

  load_rows_f32<D, kMmaRows, kMmaThreads>(
      kv[1], q + b * st.q_b + head * st.q_h, st.q_n, q0, nq);
  cp_async_commit();
  load_key_tile_f32<D, kK, kMmaThreads>(kv[0], ms[0], kb, vb, mb, st.k_n,
                                        st.v_n, 0, nk);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  FragA qa[D / 8];     // Q split once, held for the whole key loop
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    load_a<S>(qa[kk], kv[1] + warp * 16 * S, kk, lane);
  __syncthreads();  // every warp holds its Q fragments: stage 1 is free
  if (tiles > 1)
    load_key_tile_f32<D, kK, kMmaThreads>(kv[1], ms[1], kb, vb, mb, st.k_n,
                                          st.v_n, kK, nk);
  cp_async_commit();

  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const float* ks = kv[j & 1];
    const float* vs = ks + kK * S;
    const int* mk = ms[j & 1];
    const int k0 = j * kK;

    float s[kK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int n = 0; n < kK / 8; ++n)
        mma_rows<S>(s[n], qa[kk], ks, n * 8, kk, lane);
    }

    // scale after the product, mask, online softmax (rows g and g + 8)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        const float x = k0 + col >= nk   ? -INFINITY
                        : mk[col] == 0 ? kFill2
                                       : s[n][e] * scale_log2;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key k0 < nk exists; exp2(-inf) = 0 on the first tile
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P.V, P split into TF32 hi and lo straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk) {
      FragA pa;
      acc_as_a(pa, s[kk]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma_cols<S>(acc[dn], pa, vs, kk * 8, dn * 8, lane);
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < tiles)
      load_key_tile_f32<D, kK, kMmaThreads>(kv[j & 1], ms[j & 1], kb, vb, mb,
                                            st.k_n, st.v_n, (j + 2) * kK, nk);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= nq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* op = o + (((int64_t)b * nq + row) * h + head) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    if (kWithLse && tq == 0)
      lse[(int64_t)bh * nq + row] = m[r] * kLn2 + logf(l_safe);
  }
}

template <int D, bool kWithLse>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, void* o, float* lse, int b, int nq,
                   int nk, int h, const Strides& st, float scale, int dtype,
                   cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((nq + kMmaRows - 1) / kMmaRows, b * h);
    flash_fwd_mma<D, kWithLse><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), lse, nq, nk,
        h, st, scale * kLog2e);
  } else {
    const dim3 grid((nq + kMmaRows - 1) / kMmaRows, b * h);
    flash_fwd_tf32<D, kWithLse><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<float*>(o), lse, nq,
        nk, h, st, scale * kLog2e);
  }
  return cudaGetLastError();
}

template <bool kWithLse>
int dispatch(const void* q, const void* k, const void* v, const int* mask,
             void* o, float* lse, int b, int nq, int nk, int h, int d,
             const int64_t* strides, float scale, int dtype, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || h <= 0 || b * h > 65535 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (!bifold::aligned_rows(q, k, v, strides, dtype == 1 ? 8 : 4))
    return cudaErrorMisalignedAddress;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return launch<32, kWithLse>(q, k, v, mask, o, lse, b, nq, nk, h, st,
                                scale, dtype, s);
  if (d == 48)
    return launch<48, kWithLse>(q, k, v, mask, o, lse, b, nq, nk, h, st,
                                scale, dtype, s);
  if (d == 64)
    return launch<64, kWithLse>(q, k, v, mask, o, lse, b, nq, nk, h, st,
                                scale, dtype, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: element strides of q, k, v over
// (batch, token, head), nine values; the head dim is contiguous. q, k, v
// must be 16-byte aligned with strides that are multiples of 16 bytes (8
// bfloat16 or 4 float32 elements; cudaErrorMisalignedAddress otherwise).
// mask is int32 (B, nk) contiguous, or null for no mask. Returns a
// cudaError_t.
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
