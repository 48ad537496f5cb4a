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
// XLA path gives. Query rows past nq and keys past nk carry no mass.
//
// Training runs it in every flagship fusion layer (B=2 x 16 heads, n 2373,
// d 48, key mask over the context frames), every SigLIP vision layer (8
// frames x 12 heads, n 576, d 64, no mask) and every rgb_clip fusion layer
// (B=2 x 16 heads, n 275, d 32, no mask). Instanced at head dims 32, 48
// and 64.
//
// Design. The TPU kernel walks the q blocks of one (b*h) row in sequence and
// keeps full-row f32 dk/dv blocks resident in VMEM across them. On Hopper
// blocks run in any order and a block has at most 227 KB of shared memory,
// so that does not transfer. Instead, route (a) of the two usual ones:
//
//   1. a key-major kernel: a block owns 64 keys and keeps their dk, dv f32
//      accumulators in registers while it streams q, dO, lse and delta in
//      row tiles. Each key sees every query row inside one block, so dk
//      and dv are complete when the block ends and are written once.
//   2. a query-major kernel: a block owns 64 query rows and keeps dq in
//      registers while it streams k, v and the mask, recomputing p and dp.
//
// Route (a) was taken over f32 atomicAdd into a (B, Nq, H, d) buffer
// because it is deterministic (the sum order does not depend on block
// scheduling, so two calls give bitwise-equal gradients), needs no scratch
// or zeroing pass, and is the simplest to hold exactly against the plain
// version. Its price is the recompute: 7 products per (i, j) tile instead
// of 5.
//
// What bounds it on this card: at the fusion shape one call is ~43 GFLOP per
// batch row (5 products at 2 FLOP per multiply-add) on ~30 MB of inputs and
// outputs, far above the ~295 FLOP/byte ridge, so the bound is the
// tensor-core rate: 0.0875 ms for the train step's fusion call, 0.0206 ms
// for its vision call.
//
// bf16 (the flagship): `dkdv_mma` and `dq_mma` run every product on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators;
// mma_bf16.cuh), 4 warps per block, 16 rows per warp.
//   - `dkdv_mma`: each warp owns 16 keys and computes S^T = K.Q^T and
//     dP^T = V.dO^T for 16 query columns at a time, so P^T and dS^T come
//     out of the accumulators as the A operands of dV += P^T.dO and
//     dK += dS^T.Q. The block's K and V rows stay in shared memory and
//     their A fragments are read by ldmatrix at each use: held in
//     registers instead, they took the kernel to 138 / 180 registers (d48
//     / d64) at the same speed.
//   - `dq_mma`: each warp holds the Q and dO A fragments of its 16 rows;
//     S = Q.K^T and dP = dO.V^T per 16 keys, then dQ += dS.K.
//   - The streamed operands (Q, dO, lse, delta; K, V, mask) arrive by
//     cp.async into a 2-stage ring of padded bf16 rows (D + 8 elements) and
//     are read by ldmatrix (.trans where the product's k runs over rows).
//     Rows past n are zero-filled, and p is selected to 0 (never multiplied
//     by 0) on query rows past nq and keys past nk.
//   - Scores are scaled in f32 after the product, with log2 e folded in
//     (exp2f); a masked score's p is exp2((-1e5 - lse) * log2 e), so the
//     all-masked row keeps its exact 1/nk mass.
//   - Both kernels are built for four blocks per SM (__launch_bounds__),
//     so at most 128 registers. The dk/dv kernel then spills 28-40 bytes a
//     thread at d48 and d64 (none at d32, whose column loop is unrolled by
//     two); against the compiler's own registers (dk/dv 111 / 168, dq
//     96 / 128 at d 48 / d 64) the backward measured 8% faster at d 64 and
//     5% slower at d 48, about even per train step, so one rule holds for
//     both (PERF.md, PR 4; tools/flash_variants.py measures both). A
//     minimum of 1 block is not "uncapped": it took 184-196 registers.
//   Rounding points beyond the plain version's: P^T is rounded to bf16 for
//   P^T.dO, and dS (dS^T) for dS.K and dS^T.Q. The JAX kernel keeps them in
//   f32 (its bf16 flags are off by default); the emulation in
//   tests/test_torch_flash_attention.py holds this arithmetic within the
//   bf16 tolerance of the plain version.
//   Left for a later design: wgmma on TMA-fed, swizzled tiles with a
//   producer warp. d=48's 96-byte rows fit no swizzle atom unless padded
//   or split, which is why this version stays on mma.sync.
//
// f32: `dkdv_kernel` and `dq_kernel` keep the first design on the FP32 CUDA
// cores (each row owned by two threads, one half of the head dim each,
// d-long FMA loops). They are the card's precision reference (the f32
// gradient and train-step checks hold them at 1e-4), which bf16 operands
// cannot meet; they are chosen by dtype, not as a fallback. No TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bifold::bf16;

constexpr float kMaskFill = -100000.0f;  // the XLA backend's fill value
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides over (batch, token, head); D contiguous
  int64_t q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;  // keys (dk/dv) or query rows (dq) per block
constexpr int kStream = 64;        // streamed keys per ring stage (dq)
constexpr int kBlocksPerSM = 4;    // caps registers at 128 a thread

// dO is (B, Nq, H, D) contiguous; lse and delta (B, H, Nq) f32 contiguous;
// dk and dv are written (B, Nk, H, D) contiguous.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSM) dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int nq, int nk, int h, Strides st, float scale) {
  using namespace bifold;
  constexpr int S = D + 8;  // shared row, padded
  // query rows per ring stage: the block's K and V stay in shared memory
  // beside the ring, and both fit the 48 KB of static shared memory with
  // 64-row stages at d 32 (31 KB) and d 48 (43 KB) and 32-row stages at d 64
  constexpr int kTile = D > 48 ? 32 : 64;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(128) bf16 kvs[2 * kOwn * S];  // K rows, then V rows
  __shared__ __align__(128) bf16 qo[2][2 * kTile * S];  // ring: Q, then dO
  __shared__ float ls[2][kTile];
  __shared__ float dls[2][kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int key0 = blockIdx.x * kOwn;
  const bf16* qb = q + b * st.q_b + head * st.q_h;
  const int64_t o_n = (int64_t)h * D;  // dO row stride
  const bf16* ob = dout + ((int64_t)b * nq * h + head) * D;
  const float* lb = lse + (int64_t)bh * nq;
  const float* db = delta + (int64_t)bh * nq;
  const int tiles = (nq + kTile - 1) / kTile;

  auto load_tile = [&](int stage, int r0) {
    load_rows<D, kTile, kMmaThreads>(qo[stage], qb, st.q_n, r0, nq);
    load_rows<D, kTile, kMmaThreads>(qo[stage] + kTile * S, ob, o_n, r0, nq);
    load_vec<kTile>(ls[stage], lb, r0, nq);
    load_vec<kTile>(dls[stage], db, r0, nq);
  };

  load_rows<D, kOwn, kMmaThreads>(kvs, k + b * st.k_b + head * st.k_h, st.k_n,
                                  key0, nk);
  load_rows<D, kOwn, kMmaThreads>(kvs + kOwn * S,
                                  v + b * st.v_b + head * st.v_h, st.v_n,
                                  key0, nk);
  load_tile(0, 0);
  cp_async_commit();  // K, V and tile 0
  if (tiles > 1) load_tile(1, kTile);
  cp_async_commit();

  // this lane's keys: rows g and g + 8 of the warp's 16
  bool valid[2], kept[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 16 + (lane >> 2) + 8 * r;
    valid[r] = key < nk;
    kept[r] = valid[r] && (mask == nullptr || mask[(int64_t)b * nk + key] != 0);
  }
  const float scale_log2 = scale * kLog2e;
  const bf16* kw = kvs + warp * 16 * S;  // this warp's 16 K rows
  const bf16* vw = kw + kOwn * S;        // ... and V rows
  float dka[D / 8][4] = {};
  float dva[D / 8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const bf16* qs = qo[j & 1];
    const bf16* os = qs + kTile * S;
    const float* lq = ls[j & 1];
    const float* dl = dls[j & 1];
    const int r0 = j * kTile;
    // fully unrolled, the d32 instance spilled 36 B at the 128-register
    // cap; two columns at a time it holds 126 registers, no spill, 4% faster
    // (tools/flash_variants.py bwd_d32_unroll2; PERF.md, PR 8)
#pragma unroll(D == 32 ? 2 : kTile / 16)
    for (int c = 0; c < kTile / 16; ++c) {  // 16 query columns at a time
      float sc[2][4] = {};
      float dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_at = a_row(lane) * S + kk * 16 + a_col(lane);
        const int at = (c * 16 + b_row(lane)) * S + kk * 16 + b_col(lane);
        uint32_t ka[4], va[4], bq[4], bo[4];
        ldmatrix_x4(ka, &kw[a_at]);
        ldmatrix_x4(bq, &qs[at]);
        mma_bf16(sc[0], ka, bq[0], bq[1]);
        mma_bf16(sc[1], ka, bq[2], bq[3]);
        ldmatrix_x4(va, &vw[a_at]);
        ldmatrix_x4(bo, &os[at]);
        mma_bf16(dp[0], va, bo[0], bo[1]);
        mma_bf16(dp[1], va, bo[2], bo[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + n * 8 + 2 * tq + (e & 1);
          const int r = e >> 1;
          const float x = kept[r]
                              ? fmaf(sc[n][e], scale_log2, -lq[col] * kLog2e)
                              : (kMaskFill - lq[col]) * kLog2e;
          const float p = valid[r] && r0 + col < nq ? exp2f(x) : 0.f;
          dp[n][e] = kept[r] ? p * (dp[n][e] - dl[col]) * scale : 0.f;
          sc[n][e] = p;
        }
      }
      // P^T and dS^T, rounded to bf16, are the A operands of this k-step
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
      const uint32_t sa[4] = {pack_bf16(dp[0][0], dp[0][1]),
                              pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]),
                              pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const int at = (c * 16 + a_row(lane)) * S + dd * 16 + a_col(lane);
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, &os[at]);
        mma_bf16(dva[2 * dd], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * dd + 1], pa, bo[2], bo[3]);
        ldmatrix_x4_trans(bq, &qs[at]);
        mma_bf16(dka[2 * dd], sa, bq[0], bq[1]);
        mma_bf16(dka[2 * dd + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < tiles) load_tile(j & 1, (j + 2) * kTile);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const int key = key0 + warp * 16 + (lane >> 2) + 8 * r;
    const int64_t at = (((int64_t)b * nk + key) * h + head) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + n * 8) =
          pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + n * 8) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// dq is written (B, Nq, H, D) contiguous.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSM) dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int nq, int nk,
    int h, Strides st, float scale) {
  using namespace bifold;
  constexpr int S = D + 8;  // shared row, padded
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kOwn <= kStream, "Q and dO borrow one ring stage");
  // ring stage: K rows, then V rows; Q and dO are staged in stage 1 first
  __shared__ __align__(128) bf16 kv[2][2 * kStream * S];
  __shared__ int ms[2][kStream];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.x * kOwn;
  const bf16* kb = k + b * st.k_b + head * st.k_h;
  const bf16* vb = v + b * st.v_b + head * st.v_h;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;
  const int tiles = (nk + kStream - 1) / kStream;

  load_rows<D, kOwn, kMmaThreads>(kv[1], q + b * st.q_b + head * st.q_h,
                                  st.q_n, q0, nq);
  load_rows<D, kOwn, kMmaThreads>(kv[1] + kOwn * S,
                                  dout + ((int64_t)b * nq * h + head) * D,
                                  (int64_t)h * D, q0, nq);
  cp_async_commit();
  load_key_tile<D, kStream, kMmaThreads>(kv[0], ms[0], kb, vb, mb, st.k_n,
                                         st.v_n, 0, nk);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qa[D / 16][4], oa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = (warp * 16 + a_row(lane)) * S + kk * 16 + a_col(lane);
    ldmatrix_x4(qa[kk], &kv[1][at]);
    ldmatrix_x4(oa[kk], &kv[1][kOwn * S + at]);
  }
  __syncthreads();  // every warp holds its Q/dO fragments: stage 1 is free
  if (tiles > 1)
    load_key_tile<D, kStream, kMmaThreads>(kv[1], ms[1], kb, vb, mb, st.k_n,
                                           st.v_n, kStream, nk);
  cp_async_commit();

  // this lane's query rows: g and g + 8 of the warp's 16
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < nq ? lse[(int64_t)bh * nq + row] * kLog2e : 0.f;
    dl[r] = row < nq ? delta[(int64_t)bh * nq + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float dqa[D / 8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const bf16* ks = kv[j & 1];
    const bf16* vs = ks + kStream * S;
    const int* mk = ms[j & 1];
#pragma unroll
    for (int c = 0; c < kStream / 16; ++c) {  // 16 keys at a time
      float sc[2][4] = {};
      float dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int at = (c * 16 + b_row(lane)) * S + kk * 16 + b_col(lane);
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, &ks[at]);
        mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
        mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
        ldmatrix_x4(bv, &vs[at]);
        mma_bf16(dp[0], oa[kk], bv[0], bv[1]);
        mma_bf16(dp[1], oa[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + n * 8 + 2 * tq + (e & 1);
          const int r = e >> 1;
          // masked keys and keys past nk: ds = 0, p is not needed
          dp[n][e] = mk[col] != 0
                         ? exp2f(fmaf(sc[n][e], scale_log2, -lse2[r])) *
                               (dp[n][e] - dl[r]) * scale
                         : 0.f;
        }
      }
      // dS, rounded to bf16, is the A operand of this k-step
      const uint32_t sa[4] = {pack_bf16(dp[0][0], dp[0][1]),
                              pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]),
                              pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, &ks[(c * 16 + a_row(lane)) * S + dd * 16 +
                                  a_col(lane)]);
        mma_bf16(dqa[2 * dd], sa, bk[0], bk[1]);
        mma_bf16(dqa[2 * dd + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < tiles)
      load_key_tile<D, kStream, kMmaThreads>(kv[j & 1], ms[j & 1], kb, vb, mb,
                                             st.k_n, st.v_n,
                                             (j + 2) * kStream, nk);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= nq) continue;
    bf16* out = dq + (((int64_t)b * nq + row) * h + head) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_bf16(dqa[n][2 * r], dqa[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32: FP32 CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;              // rows a block owns, two threads each
constexpr int kThreads = 2 * kRows;
constexpr int kTile = 64;              // rows per streamed shared-memory tile

// Shared-memory row of head dim D: first half at 0, second half at kOff.
template <int D>
struct Row {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int kHalf = D / 2;
  static constexpr int kPad = (kHalf % 32 == 0) ? 4 : 0;  // bank shift
  static constexpr int kOff = kHalf + kPad;
  static constexpr int kLen = D + kPad;
};

// rows x D elements from global (row stride in elements, head dim
// contiguous) into shared rows
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t row_stride, int rows) {
  using R = Row<D>;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * R::kLen + (c < R::kHalf ? c : c + R::kPad)] =
        src[(int64_t)r * row_stride + c];
  }
}

// this thread's half of one head-dim row, from global into registers
template <int H>
__device__ __forceinline__ void load_half(float* dst, const float* src,
                                          bool on) {
#pragma unroll
  for (int c = 0; c < H; ++c) dst[c] = on ? src[c] : 0.f;
}

template <int H>
__device__ __forceinline__ void store_half(float* dst, const float* src) {
#pragma unroll
  for (int c = 0; c < H; ++c) dst[c] = src[c];
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

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int nq, int nk, int h, Strides st, float scale) {
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
  load_half<H>(kr, k + b * st.k_b + (int64_t)key * st.k_n + head * st.k_h
                       + half * H, active);
  load_half<H>(vr, v + b * st.v_b + (int64_t)key * st.v_n + head * st.v_h
                       + half * H, active);
#pragma unroll
  for (int c = 0; c < H; ++c) dkr[c] = dvr[c] = 0.f;

  const float* qb = q + b * st.q_b + head * st.q_h;
  const int64_t o_n = (int64_t)h * D;               // dO row stride
  const float* ob = dout + ((int64_t)b * nq * h + head) * D;
  const float* lb = lse + (int64_t)bh * nq;
  const float* db = delta + (int64_t)bh * nq;
  const int off = half * R::kOff;

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    const int tile = min(kTile, nq - q0);
    __syncthreads();  // every pair is done with the previous tile
    stage<D>(qs, qb + (int64_t)q0 * st.q_n, st.q_n, tile);
    stage<D>(dos, ob + (int64_t)q0 * o_n, o_n, tile);
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
    store_half<H>(dk + at, dkr);
    store_half<H>(dv + at, dvr);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int nq, int nk,
    int h, Strides st, float scale) {
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
  load_half<H>(qr, q + b * st.q_b + (int64_t)row * st.q_n + head * st.q_h
                       + half * H, active);
  load_half<H>(dor, dout + (((int64_t)b * nq + row) * h + head) * D
                        + half * H, active);
#pragma unroll
  for (int c = 0; c < H; ++c) dqr[c] = 0.f;
  const float l = active ? lse[(int64_t)bh * nq + row] : 0.f;
  const float dl = active ? delta[(int64_t)bh * nq + row] : 0.f;

  const float* kb = k + b * st.k_b + head * st.k_h;
  const float* vb = v + b * st.v_b + head * st.v_h;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;
  const int off = half * R::kOff;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    const int tile = min(kTile, nk - k0);
    __syncthreads();  // every pair is done with the previous tile
    stage<D>(ks, kb + (int64_t)k0 * st.k_n, st.k_n, tile);
    stage<D>(vs, vb + (int64_t)k0 * st.v_n, st.v_n, tile);
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
    store_half<H>(dq + (((int64_t)b * nq + row) * h + head) * D + half * H,
                  dqr);
}

// the dk/dv kernel, then the dq kernel, on one stream
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, int b,
                   int nq, int nk, int h, const Strides& st, float scale,
                   int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    using T = bf16;
    const T* qp = static_cast<const T*>(q);
    const T* kp = static_cast<const T*>(k);
    const T* vp = static_cast<const T*>(v);
    const T* op = static_cast<const T*>(dout);
    dkdv_mma<D><<<dim3((nk + kOwn - 1) / kOwn, b * h), kMmaThreads, 0,
                  stream>>>(qp, kp, vp, mask, op, lse, delta,
                            static_cast<T*>(dk), static_cast<T*>(dv), nq, nk,
                            h, st, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_mma<D><<<dim3((nq + kOwn - 1) / kOwn, b * h), kMmaThreads, 0,
                stream>>>(qp, kp, vp, mask, op, lse, delta,
                          static_cast<T*>(dq), nq, nk, h, st, scale);
    return cudaGetLastError();
  }
  using T = float;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(dout);
  dkdv_kernel<D><<<dim3((nk + kRows - 1) / kRows, b * h), kThreads, 0,
                   stream>>>(qp, kp, vp, mask, op, lse, delta,
                             static_cast<T*>(dk), static_cast<T*>(dv), nq, nk,
                             h, st, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3((nq + kRows - 1) / kRows, b * h), kThreads, 0,
                 stream>>>(qp, kp, vp, mask, op, lse, delta,
                           static_cast<T*>(dq), nq, nk, h, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv alike).
// strides: element strides of q, k, v over (batch, token, head), nine
// values; the head dim is contiguous. bfloat16 needs 16-byte-aligned q, k, v
// and strides that are multiples of 8 (cudaErrorMisalignedAddress
// otherwise). dout is (B, Nq, H, D) contiguous, lse and delta float32
// (B, H, Nq) contiguous, mask int32 (B, nk) contiguous or null. dq, dk, dv
// are written contiguous in the JAX layout. Launches the dk/dv kernel, then
// the dq kernel, on `stream`; returns a cudaError_t.
int bifold_flash_bwd(const void* q, const void* k, const void* v,
                     const int* mask, const void* dout, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, int b,
                     int nq, int nk, int h, int d, const int64_t* strides,
                     float scale, int dtype, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || h <= 0 || b * h > 65535 ||
      lse == nullptr || delta == nullptr || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (dtype == 1 && !bifold::aligned_rows(q, k, v, strides))
    return cudaErrorMisalignedAddress;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return launch<32>(q, k, v, mask, dout, lse, delta, dq, dk, dv, b, nq, nk,
                      h, st, scale, dtype, s);
  if (d == 48)
    return launch<48>(q, k, v, mask, dout, lse, delta, dq, dk, dv, b, nq, nk,
                      h, st, scale, dtype, s);
  if (d == 64)
    return launch<64>(q, k, v, mask, dout, lse, delta, dq, dk, dv, b, nq, nk,
                      h, st, scale, dtype, s);
  return cudaErrorInvalidValue;
}

const char* bifold_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
