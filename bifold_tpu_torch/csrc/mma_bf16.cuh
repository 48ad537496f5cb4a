// Warp-level bf16 tensor-core and asynchronous-copy primitives shared by the
// bf16 flash kernels (flash_fwd.cu, flash_bwd.cu), sm_80 PTX run on sm_90a.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// for lane l with g = l >> 2 and t = l & 3:
//   A (16 x 16, 4 regs of bf16x2): a0 (row g, k 2t..2t+1), a1 (row g+8,
//     k 2t..), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..);
//   B (16 x 8, 2 regs): b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);
//   C/D (16 x 8, 4 f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two adjacent 8-column tiles are, packed to bf16x2,
// the A fragment of their 16 columns: a probability or dS tile goes from
// the accumulators straight into the next product.
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of lane l receives its row g, cols
// 2t..2t+1 (with .trans: rows 2t..2t+1 of col g). The kernels keep their
// tiles in shared memory as rows of D bf16 plus 8 of padding, so that the
// eight 16-byte row reads of one matrix fall in eight different bank
// groups (96- and 128-byte rows become 112 and 144 bytes).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bifold {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with !pred nothing is read and
// the 16 bytes are zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// the same for 4 bytes (an int mask entry, an f32 lse or delta)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b on the tensor cores, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A-operand rows of a 16-row slab: lane l addresses row (l & 15), column
// block (l >> 4) of 8; with .trans the same addresses give the B operand of
// a product whose k runs over those rows (P.V, P^T.dO, dS^T.Q, dS.K)
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }

// B-operand rows of two 8-row n-tiles whose k runs along the row (Q.K^T,
// K.Q^T, dO.V^T, V.dO^T): lane l addresses row (l & 7) + 8 (l >> 4),
// column block (l >> 3) & 1 of 8; registers 0, 1 are b0, b1 of the first
// n-tile and 2, 3 those of the second
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

// rows [row0, row0 + kRows) of a (n, D) bf16 operand (row stride in
// elements, D contiguous, every row 16-byte aligned) into shared rows of
// D + 8 elements by 16-byte cp.async; rows at or past n are zero-filled
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (ok ? (int64_t)(row0 + r) * row_stride : 0) + c * 8, ok);
  }
}

// entries [i0, i0 + kRows) of a contiguous 4-byte vector into shared
// memory, zero past n
template <int kRows, typename V>
__device__ __forceinline__ void load_vec(V* dst, const V* src, int i0,
                                         int n) {
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
    const bool ok = i0 + i < n;
    cp_async4(dst + i, src + (ok ? i0 + i : 0), ok);
  }
}

// one ring stage of keys [k0, k0 + kRows): the K rows, then the V rows
// (`kv`), and the key mask (`ms`: mask != 0 kept, 0 masked or past nk; with
// no mask, 1 below nk)
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_key_tile(bf16* kv, int* ms,
                                              const bf16* kb, const bf16* vb,
                                              const int* mb, int64_t k_n,
                                              int64_t v_n, int k0, int nk) {
  load_rows<D, kRows, kThreads>(kv, kb, k_n, k0, nk);
  load_rows<D, kRows, kThreads>(kv + kRows * (D + 8), vb, v_n, k0, nk);
  if (mb != nullptr) {
    load_vec<kRows>(ms, mb, k0, nk);
  } else {
    for (int i = threadIdx.x; i < kRows; i += kThreads) ms[i] = k0 + i < nk;
  }
}

// the 16-byte cp.async rows need 16-byte-aligned q, k, v and (batch, token,
// head) strides, nine of them, that are multiples of `elems`, the elements
// in 16 bytes (8 bf16, 4 f32)
inline bool aligned_rows(const void* q, const void* k, const void* v,
                         const int64_t* strides, int elems) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return false;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % elems != 0) return false;
  return true;
}

}  // namespace bifold
