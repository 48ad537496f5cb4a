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
//     - xhat * mean(dxhat * xhat)), all in f32, each product and
//     difference rounded as the plain version rounds it; the two row means
//     are compensated sums (two-sum per lane and across the warp), within
//     about one ulp of the exact means, because on a constant row rstd =
//     1/sqrt(eps) multiplies their error by up to 1000;
//   - rows (x, delta, dy, ds_out, s, out, dx) are float32 or bfloat16, all of
//     one type, contiguous (R, C) with 16-byte aligned bases; C is a multiple
//     of 128 up to 1024; any R >= 1 runs, with no padding.
//
// Layout. One warp owns one row. A lane owns chunks of 8 consecutive
// columns, chunk j going to lane j % 32: a bf16 chunk is one 16-byte load,
// an f32 chunk two, and a warp's loads of one chunk index cover one
// contiguous span of the row. 768 columns are 96 chunks, 3 per lane; the
// number of chunks a lane holds is a template parameter. The row sums are
// reduced by an xor-butterfly of warp shuffles, which leaves the same bits
// in every lane. The TPU's 256-row padding is gone: a warp past R stores
// nothing. The forward keeps its row in registers and reads it once.
//
// What bounds them on this card: bytes. A call reads and writes each row
// tensor once: the forward 2 (x, out; 4 fused: x, delta, s, out), the
// backward 3 (x, dy, dx) or 4 fused (s, dy, ds_out, ds), plus f32 row stats
// and (C,) parameters. At the flagship's largest shape (4746 x 768 bf16)
// one row tensor is 7.3 MB, ~2.2 us at 3.35 TB/s, and the arithmetic
// (~10-14 FLOP per element) is far below the ~295 FLOP/byte ridge. At these
// sizes a call is a few microseconds, so a launch, the card's gap between
// two kernels and the time to get every row's loads in flight cost as much
// as the bytes.
//
// The backward. The TPU kernel sums dscale and dbias in one VMEM block
// carried across a sequential grid; Hopper's blocks run in no order. A
// two-kernel design (a grid-stride row kernel writing one f32 partial row
// per block, then a kernel summing the partials) reached 28% of its bound,
// held back by four things, each answered here:
//   1. Two launches per call, each with its ramp and the gap between them.
//      -> One cooperative launch (cudaLaunchCooperativeKernel: the grid is
//      all resident, or the launch fails and the wrapper raises). Each
//      block writes its f32 partial row, the grid meets at the cooperative
//      groups' grid barrier (cg::this_grid().sync(), whose state the
//      runtime keeps with the launch: no workspace, no memset), and each
//      block then sums 16 columns over every partial row: lane 4r + q of
//      warp w takes 4 columns of partial rows 8w + r, 8w + r + 32, ... in
//      order (a warp's load is 8 rows of 64 contiguous bytes), then a
//      butterfly over the lanes and the warps in order. The order is fixed
//      by the grid, so two calls on the same inputs give bitwise equal dx,
//      dscale and dbias; no atomic touches a sum. (The last block to arrive
//      summing every partial alone would read ~1.6 MB through one SM; the
//      barrier spreads that over the grid.)
//   2. Few rows in flight: each warp loaded a row, reduced it, stored it,
//      and only then asked for the next. -> Each warp stages its rows in
//      shared memory through a ring of kStages = 2 slots, each filled by
//      one 1-D bulk copy (TMA) per row tensor, started by lane 0 and
//      completing on the slot's mbarrier; the row's mean and rstd go to
//      registers, indexed by the (unrolled) slot. The next row is asked
//      for as soon as the current one has landed, before it is reduced and
//      stored, and only the first row is asked for at the start: asked for
//      all at once, every warp's first row would land last. Bulk TMA
//      rather than per-lane cp.async: one instruction per row and tensor
//      instead of 3-6 per lane, and no register holds data in flight. On
//      an H100 80GB HBM3 at 700 W this order measured fastest of those
//      tried: 2 slots before 3 or 4, one first row before asking
//      for 2 rows at once, contiguous rows per warp before grid-stride,
//      dx stored from registers before a bulk store from shared memory.
//   3. ~190 registers per thread (scale, the f32 row and the partial sums
//      held per lane), 2 blocks of 4 warps per SM. -> The row stays in
//      shared memory and is read from it twice (once for the two row sums,
//      once for dx), scale is kept there as f32, and only the partial sums
//      of dscale and dbias live in registers (16 per chunk): with
//      __launch_bounds__(128, 4) the compiler keeps each instance within
//      128 registers. The grid is sized by the wrapper from the SM count
//      and the occupancy the built kernel gets (bifold_ln_bwd_occupancy):
//      the fewest resident blocks that give no warp more rows than the
//      full card would; warp g of W takes rows [g R / W, (g + 1) R / W),
//      so warps differ by one row at most and there are no more partials
//      than needed.
//   4. ds_out loaded only after both reductions, and the partial row
//      written warp by warp behind a __syncthreads each. -> ds_out is
//      staged with x and dy; the block's warps put their partial sums in
//      shared memory together and every thread adds them, in warp order,
//      for its columns.
// What is left: a call still pays the launch (~2 us between two queued
// kernels), the wait for the first rows, and after the slowest block's
// rows the drain of its stores, the barrier and one round trip for the
// column sums (~3 us together at the flagship's shapes).
// scale and the row stats are read as before; all arithmetic is f32, the
// fused ds_out added before the cast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"   // smem_addr

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;                  // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;                    // columns per chunk
constexpr int kMaxSlots = 4;               // chunks per lane
constexpr int kMaxCols = 32 * kVec * kMaxSlots;   // 1024
constexpr int kStages = 2;                 // backward: rows staged per warp
constexpr int kBwdBlocksPerSM = 4;         // backward: <= 128 registers
constexpr int kColBatch = 16;              // backward: partial rows a thread
                                           // loads at once in the column sums

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

// Knuth's two-sum: s = fl(a + b) and e = (a + b) - s exactly. e is the
// exact error, so the result does not depend on which of a, b comes first.
// The _rn intrinsics keep the compiler from contracting or reordering.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// a compensated running sum: hi + lo, with lo gathering the error of each
// addition into hi
__device__ __forceinline__ void add_compensated(float& hi, float& lo, float v) {
  float e;
  two_sum(hi, v, hi, e);
  lo = __fadd_rn(lo, e);
}

// the butterfly over (hi, lo) pairs, then hi + lo: within about one ulp of
// the exact sum of the 32 lanes' terms, whose order then hardly matters.
// Every lane ends with the same bits (two_sum's s and e, and lo + lo', are
// symmetric in the two lanes).
__device__ __forceinline__ float warp_sum_compensated(float hi, float lo) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ohi = __shfl_xor_sync(0xffffffffu, hi, o);
    const float olo = __shfl_xor_sync(0xffffffffu, lo, o);
    float e;
    two_sum(hi, ohi, hi, e);
    lo = __fadd_rn(__fadd_rn(lo, olo), e);
  }
  return __fadd_rn(hi, lo);
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

// scale as f32 in shared memory, columns 4k..4k+3 of chunk k in the first
// half and 4k+4..4k+7 in the second: one contiguous span per half
__device__ __forceinline__ void scale8(const float* sc, int chunk, int cols,
                                       float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(sc)[chunk];
  const float4 b = reinterpret_cast<const float4*>(sc + cols / 2)[chunk];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 1-D bulk copies (TMA) completing on an mbarrier in shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(bifold::smem_addr(bar)) : "memory");
}

// expect `bytes` on `bar` and copy `bytes` (a multiple of 16, 16-byte
// aligned ends) from global `src` to shared `dst`; after a generic-proxy
// read of `dst`, the async proxy's write is ordered behind it
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n"
               "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];\n"
               :: "r"(bifold::smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(bifold::smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bifold::smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile("{\n"
               ".reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n"
               "}\n"
               :: "r"(bifold::smem_addr(bar)), "r"(parity) : "memory");
}

// dynamic shared memory of a backward block: scale (f32), each warp's
// mbarriers and staged rows; the same bytes as the rows then hold the
// warps' partial sums (2 x cols f32 each), never more than the rows
template <typename T, bool kFused>
size_t bwd_smem(int cols) {
  return sizeof(float) * cols + sizeof(uint64_t) * kWarps * kStages +
         sizeof(T) * kWarps * kStages * (kFused ? 3 : 2) * cols;
}

// One cooperative launch per call: rows, then each block's partial sums of
// dscale and dbias, the grid barrier, then the column sums.
template <typename T, int S, bool kFused>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM) ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const T* __restrict__ ds_out, const float* __restrict__ mean,
    const float* __restrict__ rstd, const void* __restrict__ scale,
    int param_bf16, T* __restrict__ dx, float* partial,
    float* __restrict__ dscale, float* __restrict__ dbias, int rows,
    int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRowT = kFused ? 3 : 2;  // x (or s), dy, and ds_out
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = cols / kVec;
  const unsigned row_bytes = cols * sizeof(T);
  float* sc = reinterpret_cast<float*>(smem);                    // cols
  uint64_t* bars = reinterpret_cast<uint64_t*>(sc + cols) + warp * kStages;
  T* rings = reinterpret_cast<T*>(reinterpret_cast<uint64_t*>(sc + cols) +
                                  kWarps * kStages);
  T* ring = rings + static_cast<int64_t>(warp) * kStages * kRowT * cols;

  // rows first: warp g of the W in the grid takes rows [g R / W, (g + 1) R
  // / W), floor or ceil of R / W of them, in order. Its i-th row goes to
  // slot i % kStages, whose mbarrier completes phase i / kStages when the
  // row's bytes have landed.
  const int64_t nwarps = gridDim.x * kWarps;
  const int64_t gw = blockIdx.x * kWarps + warp;
  const int row0 = static_cast<int>(gw * rows / nwarps);
  const int mine = static_cast<int>((gw + 1) * rows / nwarps) - row0;
  float mu[kStages], rs[kStages];
  auto fetch = [&](int i, int slot) {
    const int row = row0 + i;
    if (lane == 0) {
      const int64_t base = static_cast<int64_t>(row) * cols;
      T* dst = ring + slot * kRowT * cols;
      mbar_expect(&bars[slot], kRowT * row_bytes);
      bulk_load(dst, x + base, row_bytes, &bars[slot]);
      bulk_load(dst + cols, dy + base, row_bytes, &bars[slot]);
      if constexpr (kFused) bulk_load(dst + 2 * cols, ds_out + base, row_bytes, &bars[slot]);
    }
    mu[slot] = mean[row];
    rs[slot] = rstd[row];
  };
  if (lane == 0)
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
  __syncwarp();
  if (mine > 0) fetch(0, 0);
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    float v[kVec];
    load8_param(scale, param_bf16, k * kVec, v);
    reinterpret_cast<float4*>(sc)[k] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(sc + cols / 2)[k] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  float dsc[S][kVec], dbi[S][kVec];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) dsc[j][e] = dbi[j][e] = 0.f;

  for (int i0 = 0; i0 < mine; i0 += kStages) {
#pragma unroll
    for (int slot = 0; slot < kStages; ++slot) {  // static slot: mu, rs in registers
      const int i = i0 + slot;
      if (i >= mine) break;
      mbar_wait(&bars[slot], (i / kStages) & 1);
      // rows i + 1 .. i + kStages - 1 in flight while row i is worked: the
      // first row alone is asked for at the start (asked for all at once,
      // every warp's first row would land last), the rest once it is in
#pragma unroll
      for (int a = 1; a < kStages; ++a)
        if (i + a < mine && (a == kStages - 1 || i == 0))
          fetch(i + a, (slot + a) % kStages);
      const T* xs = ring + slot * kRowT * cols;
      const T* gs = xs + cols;
      // the row means of dxhat and dxhat * xhat, each term rounded as the
      // plain version rounds it, summed with compensation: on a constant
      // row rstd = 1/sqrt(eps) (up to 1000) multiplies any error of m1
      float hi1 = 0.f, lo1 = 0.f, hi2 = 0.f, lo2 = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int chunk = j * 32 + lane;
        if (chunk < chunks) {
          float xv[kVec], g[kVec], s8[kVec];
          load8(xs + chunk * kVec, xv);
          load8(gs + chunk * kVec, g);
          scale8(sc, chunk, cols, s8);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float xh = (xv[e] - mu[slot]) * rs[slot];
            dsc[j][e] += g[e] * xh;
            dbi[j][e] += g[e];
            const float gh = __fmul_rn(g[e], s8[e]);  // dxhat
            add_compensated(hi1, lo1, gh);
            add_compensated(hi2, lo2, __fmul_rn(gh, xh));
          }
        }
      }
      const float m1 = warp_sum_compensated(hi1, lo1) / cols;
      const float m2 = warp_sum_compensated(hi2, lo2) / cols;
      const int64_t base = static_cast<int64_t>(row0 + i) * cols;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int chunk = j * 32 + lane;
        if (chunk < chunks) {
          float xv[kVec], g[kVec], s8[kVec], d[kVec];
          load8(xs + chunk * kVec, xv);
          load8(gs + chunk * kVec, g);
          scale8(sc, chunk, cols, s8);
          if constexpr (kFused) load8(xs + 2 * cols + chunk * kVec, d);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float xh = (xv[e] - mu[slot]) * rs[slot];
            // rounded as the plain version rounds: no contraction
            const float v = rs[slot] * __fsub_rn(__fsub_rn(__fmul_rn(g[e], s8[e]), m1),
                                                 __fmul_rn(xh, m2));
            if constexpr (kFused)
              d[e] += v;  // the residual stream's cotangent folded in
            else
              d[e] = v;
          }
          store8(dx + base + chunk * kVec, d);
        }
      }
      __syncwarp();  // every lane has read the slot before its refill
    }
  }

  // the block's partial sums: its warps' in shared memory, added in warp
  // order, one (2, cols) f32 row of the scratch per block
  __syncthreads();
  float* red = reinterpret_cast<float*>(rings);  // [kWarps][2 * cols]
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int chunk = j * 32 + lane;
    if (chunk < chunks) {
      float* mine_dsc = red + warp * 2 * cols + chunk * kVec;
      store8(mine_dsc, dsc[j]);
      store8(mine_dsc + cols, dbi[j]);
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(partial + static_cast<int64_t>(blockIdx.x) * 2 * cols);
  for (int q = threadIdx.x; q < cols / 2; q += kThreads) {
    const float4* r4 = reinterpret_cast<const float4*>(red);
    float4 a = r4[q];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 b = r4[w * cols / 2 + q];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    __stcg(dst + q, a);
  }

  // every block's partial row is written and visible to every block
  cg::this_grid().sync();

  // dscale | dbias: 16 columns per block. Lane 4r + q of warp w takes the
  // 4 columns q of partial rows 8w + r, 8w + r + 32, ... in order (a warp's
  // load is 8 rows x 64 contiguous bytes), then the lanes of each q are
  // added by a butterfly and the warps in order.
  const int nparts = gridDim.x;
  const int quad = lane & 3;
  for (int tile = blockIdx.x; tile < cols / 8; tile += gridDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* col = reinterpret_cast<const float4*>(partial) + tile * 4 + quad;
    for (int p0 = warp * 8 + (lane >> 2); p0 < nparts; p0 += kColBatch * kThreads / 4) {
      float4 u[kColBatch];  // all loads first: one round trip
#pragma unroll
      for (int k = 0; k < kColBatch; ++k) {
        const int p = p0 + k * kThreads / 4;
        u[k] = p < nparts ? __ldcg(col + static_cast<int64_t>(p) * cols / 2)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kColBatch; ++k) {
        a.x += u[k].x; a.y += u[k].y; a.z += u[k].z; a.w += u[k].w;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
    }
    if (lane < 4) reinterpret_cast<float4*>(red)[warp * 4 + lane] = a;
    __syncthreads();
    if (threadIdx.x < 16) {
      float total = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) total += red[w * 16 + threadIdx.x];
      const int c = tile * 16 + threadIdx.x;
      if (c < cols)
        dscale[c] = total;
      else
        dbias[c - cols] = total;
    }
    __syncthreads();
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
cudaError_t bwd_occupancy(int cols, int* per_sm) {
  const auto kernel = ln_bwd_kernel<T, S, kFused>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem<T, kFused>(32 * kVec * S)));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, bwd_smem<T, kFused>(cols));
}

template <typename T, int S, bool kFused>
cudaError_t bwd_launch(const void* x, const void* dy, const void* ds_out,
                       const float* mean, const float* rstd,
                       const void* scale, int param_bf16, void* dx,
                       float* partial, float* dscale, float* dbias,
                       int blocks, int rows, int cols, cudaStream_t stream) {
  const auto kernel = ln_bwd_kernel<T, S, kFused>;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* dst = static_cast<const T*>(ds_out);
  T* dxt = static_cast<T*>(dx);
  void* args[] = {&xt,    &dyt,        &dst, &mean,    &rstd,
                  &scale, &param_bf16, &dxt, &partial, &dscale,
                  &dbias, &rows,       &cols};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                     args, bwd_smem<T, kFused>(cols), stream);
}

// dispatch on (dtype, chunks per lane, fused) to `Fn<T, S, kFused>::run`
#define BIFOLD_LN_BWD_SLOTS(T, CALL)  \
  switch ((cols / kVec + 31) / 32) {   \
    case 1: return CALL(T, 1);         \
    case 2: return CALL(T, 2);         \
    case 3: return CALL(T, 3);         \
    default: return CALL(T, 4);        \
  }

template <bool kFused>
cudaError_t occupancy_dispatch(int cols, int dtype, int* per_sm) {
#define BIFOLD_OCC(T, S) bwd_occupancy<T, S, kFused>(cols, per_sm)
  if (dtype == 1) BIFOLD_LN_BWD_SLOTS(__nv_bfloat16, BIFOLD_OCC)
  BIFOLD_LN_BWD_SLOTS(float, BIFOLD_OCC)
#undef BIFOLD_OCC
}

template <bool kFused>
int bwd_dispatch(const void* x, const void* dy, const void* ds_out,
                 const float* mean, const float* rstd, const void* scale,
                 void* dx, float* partial, float* dscale, float* dbias,
                 int rows, int cols, int blocks, int dtype, int param_dtype,
                 void* stream) {
  if (bad_shape(rows, cols, dtype, param_dtype) || blocks <= 0 ||
      blocks > 0xffff || partial == nullptr ||
      misaligned(x) || misaligned(dy) || misaligned(dx) ||
      misaligned(scale) || misaligned(partial) || misaligned(dscale) ||
      misaligned(dbias) || (kFused && misaligned(ds_out)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIFOLD_BWD(T, S)                                                  \
  bwd_launch<T, S, kFused>(x, dy, ds_out, mean, rstd, scale, param_dtype, \
                           dx, partial, dscale, dbias, blocks, rows,      \
                           cols, st)
  if (dtype == 1) BIFOLD_LN_BWD_SLOTS(__nv_bfloat16, BIFOLD_BWD)
  BIFOLD_LN_BWD_SLOTS(float, BIFOLD_BWD)
#undef BIFOLD_BWD
}

#undef BIFOLD_LN_BWD_SLOTS

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

// The backward: one cooperative launch of `blocks` blocks, every one
// resident at once (bifold_ln_bwd_occupancy gives how many fit; more and
// the launch fails; bifold_ln_bwd_occupancy, asked first on the device,
// also sets the instance's shared-memory limit). partial: float32 scratch
// of blocks x 2 x cols; dscale and dbias: float32 (cols,), 16-byte aligned.
int bifold_ln_bwd(const void* x, const void* dy, const float* mean,
                  const float* rstd, const void* scale, void* dx,
                  float* partial, float* dscale, float* dbias, int rows,
                  int cols, int blocks, int dtype, int param_dtype,
                  void* stream) {
  return bwd_dispatch<false>(x, dy, nullptr, mean, rstd, scale, dx, partial,
                             dscale, dbias, rows, cols, blocks, dtype,
                             param_dtype, stream);
}

int bifold_fused_ln_bwd(const void* s, const void* dy, const void* ds_out,
                        const float* mean, const float* rstd,
                        const void* scale, void* dx, float* partial,
                        float* dscale, float* dbias, int rows, int cols,
                        int blocks, int dtype, int param_dtype,
                        void* stream) {
  return bwd_dispatch<true>(s, dy, ds_out, mean, rstd, scale, dx, partial,
                            dscale, dbias, rows, cols, blocks, dtype,
                            param_dtype, stream);
}

// Blocks of the backward instance for (cols, dtype, fused) resident on one
// SM of the current device, the device's SM count, and the backward's warps
// per block (one row in flight each). It sets the instance's dynamic
// shared-memory limit on the device to what its widest rows need, so it is
// asked once per device and instance before the first launch.
int bifold_ln_bwd_occupancy(int cols, int dtype, int fused, int* per_sm,
                            int* sms, int* warps) {
  if (bad_shape(1, cols, dtype, 0) || per_sm == nullptr || sms == nullptr ||
      warps == nullptr)
    return cudaErrorInvalidValue;
  *warps = kWarps;
  const cudaError_t err = fused ? occupancy_dispatch<true>(cols, dtype, per_sm)
                                : occupancy_dispatch<false>(cols, dtype, per_sm);
  if (err != cudaSuccess) return err;
  int device;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

const char* bifold_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
