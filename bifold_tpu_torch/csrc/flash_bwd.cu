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
// f32: `dkdv_tf32` and `dq_tf32`, the same route (a) with every product
// 3xTF32 on the tensor cores (mma.sync m16n8k8 tf32; mma_tf32.cuh). They
// are the card's precision reference (the f32 gradient and train-step
// checks hold them at 1e-4), which bf16 or a single TF32 pass cannot meet;
// they are chosen by dtype, not as a fallback. Deterministic as the bf16
// kernels are (no atomics; two calls bitwise equal).
//   - 4 warps x 16 rows; the block's own 64 rows of two operands (K and V,
//     or Q and dO) stay in shared memory and their A fragments are split
//     into TF32 hi and lo at each use; the streamed operands (Q, dO, lse,
//     delta; K, V, mask) come by cp.async into a 2-stage ring of 32 rows.
//     Rows are padded f32 (D + 4 floats), so every fragment load, along a
//     row or down the rows with k permuted, is conflict-free.
//   - All 32 columns of a stage at once: S^T and dP^T (or S and dP) are 4
//     accumulator tiles each, and P^T / dS^T (dS) leave them as the A
//     operands of the next products with k permuted (acc_as_a), split like
//     any other operand.
//   - 69.9 / 53.5 / 37.1 KB of dynamic shared memory at d 64 / 48 / 32 (set
//     with cudaFuncAttributeMaxDynamicSharedMemorySize before each launch);
//     three blocks per SM (__launch_bounds__), 168 + 147..166 registers,
//     the d64 dk/dv kernel spilling 40 bytes. Measured against that
//     (tools/flash_variants.py, PERF.md §6): two blocks per SM (255
//     registers) 2.5-22% slower, 16-row stages 4-11% slower, 64-row
//     stages 10-13% slower, splitting each stage once into hi and lo rows
//     in shared memory up to 14% slower.

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
// f32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTileF32 = 32;        // streamed rows per ring stage
constexpr int kBlocksPerSMF32 = 3;  // caps registers at 168 a thread

// dynamic shared memory of either f32 kernel: the block's own 64 rows of
// two operands, a 2-stage ring of 32 rows of two operands, and 2 x 32
// 4-byte entries of each of two vectors (lse and delta, or the key mask);
// 69.9 / 53.5 / 37.1 KB at D = 64 / 48 / 32
template <int D>
constexpr int bwd_smem_f32() {
  return (2 * kOwn * (D + 4) + 2 * 2 * kTileF32 * (D + 4) + 2 * 2 * kTileF32) *
         4;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSMF32) dkdv_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int nq, int nk, int h, Strides st, float scale) {
  using namespace bifold;
  constexpr int S = D + 4;  // shared row, padded
  constexpr int kT = kTileF32;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  extern __shared__ __align__(128) float smem[];
  float* kvs = smem;                  // the block's K rows, then V rows
  float* ring = kvs + 2 * kOwn * S;   // 2 stages: Q rows, then dO rows
  float* ls = ring + 2 * 2 * kT * S;  // 2 stages of lse
  float* dls = ls + 2 * kT;           // 2 stages of delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int key0 = blockIdx.x * kOwn;
  const float* qb = q + b * st.q_b + head * st.q_h;
  const int64_t o_n = (int64_t)h * D;  // dO row stride
  const float* ob = dout + ((int64_t)b * nq * h + head) * D;
  const float* lb = lse + (int64_t)bh * nq;
  const float* db = delta + (int64_t)bh * nq;
  const int tiles = (nq + kT - 1) / kT;

  auto load_tile = [&](int stage, int r0) {
    float* qs = ring + stage * 2 * kT * S;
    load_rows_f32<D, kT, kMmaThreads>(qs, qb, st.q_n, r0, nq);
    load_rows_f32<D, kT, kMmaThreads>(qs + kT * S, ob, o_n, r0, nq);
    load_vec<kT>(ls + stage * kT, lb, r0, nq);
    load_vec<kT>(dls + stage * kT, db, r0, nq);
  };

  load_rows_f32<D, kOwn, kMmaThreads>(kvs, k + b * st.k_b + head * st.k_h,
                                      st.k_n, key0, nk);
  load_rows_f32<D, kOwn, kMmaThreads>(kvs + kOwn * S,
                                      v + b * st.v_b + head * st.v_h, st.v_n,
                                      key0, nk);
  load_tile(0, 0);
  cp_async_commit();  // K, V and tile 0
  if (tiles > 1) load_tile(1, kT);
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
  const float* kw = kvs + warp * 16 * S;  // this warp's 16 K rows
  const float* vw = kw + kOwn * S;        // ... and V rows
  float dka[D / 8][4] = {};
  float dva[D / 8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const float* qs = ring + (j & 1) * 2 * kT * S;
    const float* os = qs + kT * S;
    const float* lq = ls + (j & 1) * kT;
    const float* dl = dls + (j & 1) * kT;
    const int r0 = j * kT;
    // S^T = K.Q^T and dP^T = V.dO^T over the stage's 32 query columns
    float sc[kT / 8][4] = {};
    float dp[kT / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA a;
      load_a<S>(a, kw, kk, lane);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) mma_rows<S>(sc[n], a, qs, n * 8, kk, lane);
      load_a<S>(a, vw, kk, lane);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) mma_rows<S>(dp[n], a, os, n * 8, kk, lane);
    }
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        const int r = e >> 1;
        const float x = kept[r]
                            ? fmaf(sc[n][e], scale_log2, -lq[col] * kLog2e)
                            : (kMaskFill - lq[col]) * kLog2e;
        const float p = valid[r] && r0 + col < nq ? exp2f(x) : 0.f;
        dp[n][e] = kept[r] ? p * (dp[n][e] - dl[col]) * scale : 0.f;
        sc[n][e] = p;
      }
    }
    // dV += P^T.dO and dK += dS^T.Q, 8 query rows a k-step; P^T and dS^T
    // are split from the accumulators
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      FragA pa, sa;
      acc_as_a(pa, sc[n]);
      acc_as_a(sa, dp[n]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        mma_cols<S>(dva[dn], pa, os, n * 8, dn * 8, lane);
        mma_cols<S>(dka[dn], sa, qs, n * 8, dn * 8, lane);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < tiles) load_tile(j & 1, (j + 2) * kT);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const int key = key0 + warp * 16 + (lane >> 2) + 8 * r;
    const int64_t at = (((int64_t)b * nk + key) * h + head) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + at + n * 8) =
          make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at + n * 8) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSMF32) dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int nq, int nk,
    int h, Strides st, float scale) {
  using namespace bifold;
  constexpr int S = D + 4;  // shared row, padded
  constexpr int kT = kTileF32;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  extern __shared__ __align__(128) float smem[];
  float* qo = smem;                  // the block's Q rows, then dO rows
  float* ring = qo + 2 * kOwn * S;   // 2 stages: K rows, then V rows
  int* ms = reinterpret_cast<int*>(ring + 2 * 2 * kT * S);  // 2 stages of mask

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.x * kOwn;
  const float* kb = k + b * st.k_b + head * st.k_h;
  const float* vb = v + b * st.v_b + head * st.v_h;
  const int* mb = mask == nullptr ? nullptr : mask + (int64_t)b * nk;
  const int tiles = (nk + kT - 1) / kT;

  load_rows_f32<D, kOwn, kMmaThreads>(qo, q + b * st.q_b + head * st.q_h,
                                      st.q_n, q0, nq);
  load_rows_f32<D, kOwn, kMmaThreads>(
      qo + kOwn * S, dout + ((int64_t)b * nq * h + head) * D, (int64_t)h * D,
      q0, nq);
  load_key_tile_f32<D, kT, kMmaThreads>(ring, ms, kb, vb, mb, st.k_n, st.v_n,
                                        0, nk);
  cp_async_commit();  // Q, dO and key tile 0
  if (tiles > 1)
    load_key_tile_f32<D, kT, kMmaThreads>(ring + 2 * kT * S, ms + kT, kb, vb,
                                          mb, st.k_n, st.v_n, kT, nk);
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
  const float* qw = qo + warp * 16 * S;  // this warp's 16 Q rows
  const float* ow = qw + kOwn * S;       // ... and dO rows
  float dqa[D / 8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const float* ks = ring + (j & 1) * 2 * kT * S;
    const float* vs = ks + kT * S;
    const int* mk = ms + (j & 1) * kT;
    // S = Q.K^T and dP = dO.V^T over the stage's 32 keys
    float sc[kT / 8][4] = {};
    float dp[kT / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA a;
      load_a<S>(a, qw, kk, lane);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) mma_rows<S>(sc[n], a, ks, n * 8, kk, lane);
      load_a<S>(a, ow, kk, lane);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) mma_rows<S>(dp[n], a, vs, n * 8, kk, lane);
    }
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        const int r = e >> 1;
        // masked keys and keys past nk: ds = 0, p is not needed
        dp[n][e] = mk[col] != 0
                       ? exp2f(fmaf(sc[n][e], scale_log2, -lse2[r])) *
                             (dp[n][e] - dl[r]) * scale
                       : 0.f;
      }
    }
    // dQ += dS.K, 8 keys a k-step; dS is split from the accumulators
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      FragA sa;
      acc_as_a(sa, dp[n]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma_cols<S>(dqa[dn], sa, ks, n * 8, dn * 8, lane);
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < tiles)
      load_key_tile_f32<D, kT, kMmaThreads>(ring + (j & 1) * 2 * kT * S,
                                            ms + (j & 1) * kT, kb, vb, mb,
                                            st.k_n, st.v_n, (j + 2) * kT, nk);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= nq) continue;
    float* out = dq + (((int64_t)b * nq + row) * h + head) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(dqa[n][2 * r], dqa[n][2 * r + 1]);
  }
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
  // above the 48 KB of static shared memory at D = 48 and 64
  constexpr int smem = bwd_smem_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dq_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dkdv_tf32<D><<<dim3((nk + kOwn - 1) / kOwn, b * h), kMmaThreads, smem,
                 stream>>>(qp, kp, vp, mask, op, lse, delta,
                           static_cast<T*>(dk), static_cast<T*>(dv), nq, nk,
                           h, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_tf32<D><<<dim3((nq + kOwn - 1) / kOwn, b * h), kMmaThreads, smem,
               stream>>>(qp, kp, vp, mask, op, lse, delta,
                         static_cast<T*>(dq), nq, nk, h, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv alike).
// strides: element strides of q, k, v over (batch, token, head), nine
// values; the head dim is contiguous. q, k, v must be 16-byte aligned with
// strides that are multiples of 16 bytes (8 bfloat16 or 4 float32 elements;
// cudaErrorMisalignedAddress otherwise). dout is (B, Nq, H, D) contiguous,
// lse and delta float32 (B, H, Nq) contiguous, mask int32 (B, nk)
// contiguous or null. dq, dk, dv are written contiguous in the JAX layout. Launches the dk/dv kernel, then
// the dq kernel, on `stream`; returns a cudaError_t.
int bifold_flash_bwd(const void* q, const void* k, const void* v,
                     const int* mask, const void* dout, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, int b,
                     int nq, int nk, int h, int d, const int64_t* strides,
                     float scale, int dtype, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || h <= 0 || b * h > 65535 ||
      lse == nullptr || delta == nullptr || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (!bifold::aligned_rows(q, k, v, strides, dtype == 1 ? 8 : 4))
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
