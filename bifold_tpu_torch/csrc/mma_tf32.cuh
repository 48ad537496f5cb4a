// Warp-level 3xTF32 tensor-core primitives and f32 tile copies shared by the
// f32 flash kernels (flash_fwd.cu, flash_bwd.cu), sm_80 PTX run on sm_90a.
//
// 3xTF32. Each f32 operand x is split once into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (rna: round to nearest, ties away from zero, onto
// TF32's 10 mantissa bits; x - hi is exact in f32). A product a.b is then
// hi_a.hi_b + hi_a.lo_b + lo_a.hi_b on the tensor cores, accumulated in
// f32: the dropped lo_a.lo_b and lo's own rounding are below 2^-21 of |a.b|,
// so a dot product keeps f32's accuracy at three TF32 products per f32 one
// (495 TFLOP/s TF32 dense, ~165 TFLOP/s of such products, against 67
// TFLOP/s of FMA on the CUDA cores). hi is rounded, never the raw f32 bits:
// the tensor cores truncate a TF32 operand's low 13 bits.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// for lane l with g = l >> 2 and t = l & 3 (every register one value):
//   A (16 x 8): a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4),
//     a3 (row g+8, k t+4);
//   B (8 x 8): b0 (k t, col g), b1 (k t+4, col g);
//   C/D (16 x 8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// A C tile becomes the next product's A operand without a shuffle by
// permuting k: the k-position t stands for source column 2t and t + 4 for
// 2t + 1, so a = {c0, c2, c1, c3}, and the B operand reads its k-row t from
// source row 2t and k-row t + 4 from source row 2t + 1 (k_src below). The
// sum over k is the same sum in another order.
//
// Shared-memory rows hold D f32 plus 4 of padding (D + 4 = 36, 52, 68
// floats at D = 32, 48, 64; row r starts in bank 4r, 20r, 4r mod 32). The
// fragment loads are plain 32-bit ld.shared, and each falls in 32 distinct
// banks:
//   - row g, column t (+ const): banks (D + 4) g + t mod 32 = 4g + t at
//     D = 32 and 64, {0, 20, 8, 28, 16, 4, 24, 12}_g + t at D = 48;
//   - row 2t (+ 1), column g: banks 2 (D + 4) t + g = 8t + g mod 32 at all
//     three (72, 104 and 136 are 8 mod 32).
// (Unpermuted, row t and column g would meet at banks 4t + g: 2-way
// conflicts.) ldmatrix has no 32-bit transposing form, so these are the
// loads of every product, k along the row or across rows.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"  // cp.async, commit and wait, load_vec

namespace bifold {

// x rounded to TF32 (nearest, ties away from zero)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo) as above; hi's low 13 bits are cleared because hi is
// subtracted as an f32, lo's are left to the tensor cores, which ignore them
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x) & 0xffffe000u;
  lo = rna_tf32(x - __uint_as_float(hi));
}

// an A fragment of four f32 values, split
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(FragA& a, float v0, float v1, float v2,
                                        float v3) {
  split_tf32(v0, a.hi[0], a.lo[0]);
  split_tf32(v1, a.hi[1], a.lo[1]);
  split_tf32(v2, a.hi[2], a.lo[2]);
  split_tf32(v3, a.hi[3], a.lo[3]);
}

// c += a . b, one TF32 product on the tensor cores, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32 for the B fragment (b0, b1) given as f32: the two
// small products first, then hi . hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

// the A fragment of k-step kk from 16 shared rows of stride S whose k runs
// along the row (Q, dO, K, V as the left operand)
template <int S>
__device__ __forceinline__ void load_a(FragA& a, const float* rows, int kk,
                                       int lane) {
  const float* p = rows + (lane >> 2) * S + kk * 8 + (lane & 3);
  split_a(a, p[0], p[8 * S], p[4], p[8 * S + 4]);
}

// an accumulator tile as the A operand of the next product, k permuted
__device__ __forceinline__ void acc_as_a(FragA& a, const float (&c)[4]) {
  split_a(a, c[0], c[2], c[1], c[3]);
}

// c += a . B, B's 8 columns the shared rows n0.. n0 + 7 read along k (k-step
// kk): Q.K^T, dO.V^T, K.Q^T, V.dO^T
template <int S>
__device__ __forceinline__ void mma_rows(float (&c)[4], const FragA& a,
                                         const float* rows, int n0, int kk,
                                         int lane) {
  const float* p = rows + (n0 + (lane >> 2)) * S + kk * 8 + (lane & 3);
  mma_3xtf32(c, a, p[0], p[4]);
}

// c += a . B, B's k the shared rows k0.. k0 + 7 in the permuted order
// (acc_as_a) and its 8 columns d0.. d0 + 7: P.V, P^T.dO, dS^T.Q, dS.K
template <int S>
__device__ __forceinline__ void mma_cols(float (&c)[4], const FragA& a,
                                         const float* rows, int k0, int d0,
                                         int lane) {
  const float* p = rows + (k0 + 2 * (lane & 3)) * S + d0 + (lane >> 2);
  mma_3xtf32(c, a, p[0], p[S]);
}

// rows [row0, row0 + kRows) of a (n, D) f32 operand (row stride in
// elements, D contiguous, every row 16-byte aligned) into shared rows of
// D + 4 floats by 16-byte cp.async; rows at or past n are zero-filled
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t row_stride, int row0,
                                              int n) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * (D + 4) + c * 4,
               src + (ok ? (int64_t)(row0 + r) * row_stride : 0) + c * 4, ok);
  }
}

// one ring stage of keys [k0, k0 + kRows): K rows, then V rows (`kv`), and
// the key mask (`ms`: mask != 0 kept, 0 masked or past nk; with no mask, 1
// below nk)
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_key_tile_f32(float* kv, int* ms,
                                                  const float* kb,
                                                  const float* vb,
                                                  const int* mb, int64_t k_n,
                                                  int64_t v_n, int k0,
                                                  int nk) {
  load_rows_f32<D, kRows, kThreads>(kv, kb, k_n, k0, nk);
  load_rows_f32<D, kRows, kThreads>(kv + kRows * (D + 4), vb, v_n, k0, nk);
  if (mb != nullptr) {
    load_vec<kRows>(ms, mb, k0, nk);
  } else {
    for (int i = threadIdx.x; i < kRows; i += kThreads) ms[i] = k0 + i < nk;
  }
}

}  // namespace bifold
