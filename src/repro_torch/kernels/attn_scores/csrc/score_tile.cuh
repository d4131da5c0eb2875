// Tensor-core score tile of the two attention-mass kernels, K4
// (flash_fwd.cu) and K5 (key_mass.cu): exact bf16 mma.sync.m16n8k16 with
// f32 accumulators, cp.async-staged tiles, and the helpers both kernels
// stage and split their tiles with. The MMA and cp.async primitives are
// mma_tile.cuh's (K1-K3's tile), included, not copied.
//
// Both kernels hold one 64-row tile resident in shared memory (K4 its
// queries, K5 its keys; 4 warps of 16 rows, the MMA's A operand) and
// stream column tiles of CT rows past it (K4 keys, K5 queries; the MMA's
// B operand). score_tile gives each warp the scores of its 16 rows
// against the CT columns, s = a . b over the head dimension, in the m16n8
// accumulator layout: lane (g, t) holds rows g and g + 8, columns
// 8j + 2t and 8j + 2t + 1 of n8 tile j. K4 computes S = Q K^T, K5
// S^T = K Q^T: the same products, so K5's exp(s - lse) agrees with K4's
// lse.
//
// Planes and products (the scores must hold |Δ| <= 1e-4 (1 + |ref|) on
// out, lse and mass at |s| up to ~50, so no TF32 and no bf16 rounding):
//   bf16 inputs: one MMA; bf16 x bf16 products are exact in f32.
//   f32 inputs: each value x = hi + mid + lo, three bf16 planes
//     (mma_tile.cuh split3; exact while |x| >= 2^-110). Six products:
//     lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi (smallest first). The
//     three dropped ones (mid.lo, lo.mid, lo.lo) are below 2^-24 |a_d b_d|
//     each, as an f32 product's own rounding. Dropping mid.mid, the lo
//     products, or both (two planes) leaves up to 2^-16 |a_d b_d|, which
//     breaks the tolerance at large logits (tools/attn_variants.py
//     products holds the four choices against the plain versions), so
//     f32 takes 6 MMAs per score MMA.
// Each warp loads (and for f32 splits) the A fragments of its own rows of
// the resident tile: once per block where they fit in registers, else at
// every streamed tile. A streamed f32 tile lands by cp.async in an f32
// buffer and the block splits it once into bf16 planes (split_rows),
// which every warp then reads.
//
// Fragments. As in mma_tile.cuh, physical depth 4t..4t+3 of a k16 step
// stands for the logical slots {2t, 2t+1, 2t+8, 2t+9} of lane group t in
// A and in B alike, so a lane's fragment of a row is one 8-byte (bf16) or
// 16-byte (f32) shared load. Depth past D is zero in shared memory (D is
// padded to dp, a multiple of 16).
//
// Layouts (as the JAX package passes them): q, k, v (H, S, D) head-major,
// f32 or bf16, D contiguous; lse and mass (H, S) f32. Shared tiles keep
// rows dp wide in a padded stride: bf16 rows an odd multiple of 16 bytes
// (the 8 rows of a fragment load or an ldmatrix hit distinct banks), f32
// rows 16 floats off a multiple of 32 (the two rows of a quarter-warp's
// 16-byte loads hit distinct banks).
#pragma once

#include "../../quant_matmul/csrc/mma_tile.cuh"

#include <math.h>

namespace attn {

using mmt::bf162_bits;
using mmt::cp_async16;
using mmt::cp_async4;
using mmt::cp_async_commit;
using mmt::cp_async_wait;
using mmt::mma_bf16;
using mmt::smem_addr;

constexpr int ROWS = 64;          // resident rows of a block, 16 per warp
constexpr int THREADS = 128;      // 4 warps
constexpr int MAX_D = 256;
constexpr float NEG = -1e30f;     // the reference's masked logit
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows of a streamed column tile: 32 for f32 inputs wider than 64, so that
// the f32 landing buffer and the planes leave room for two blocks an SM
// at D 128; else 64.
template <typename T>
__host__ __device__ constexpr int col_rows(int dmax) {
  return sizeof(T) == 4 && dmax > 64 ? 32 : 64;
}

__host__ __device__ constexpr int pad16(int d) { return (d + 15) & ~15; }

// row strides (elements) of a bf16 tile and of an f32 tile dp wide
__host__ __device__ constexpr int ld_bf16(int dp) { return dp + 8; }
__host__ __device__ constexpr int ld_f32(int dp) {
  return (dp / 16) % 2 ? dp : dp + 16;
}

template <typename T>
__host__ __device__ constexpr int ld_rows(int dp) {
  return sizeof(T) == 4 ? ld_f32(dp) : ld_bf16(dp);
}

// the resident 64-row tile, in the inputs' type
template <typename T>
__host__ __device__ constexpr size_t row_tile_bytes(int dp) {
  return (size_t)ROWS * ld_rows<T>(dp) * sizeof(T);
}

// one bf16 column tile or plane of ct rows
__host__ __device__ constexpr size_t plane_bytes(int ct, int dp) {
  return (size_t)ct * ld_bf16(dp) * 2;
}

// one f32 landing buffer of ct rows (row stride dp)
__host__ __device__ constexpr size_t landing_bytes(int ct, int dp) {
  return (size_t)ct * dp * 4;
}

// Lets `kernel` take up to `bytes` of dynamic shared memory, with the SM's
// carveout at its largest so that two blocks of up to ~113 KB share an SM.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// ------------------------------------------------------------ staging

// f(r, c) for every row r < N and piece c < pieces of a tile, spread over
// the block's threads. Where pieces is a power of two up to THREADS (the
// head dimensions models use), each thread keeps one piece and walks the
// rows: no integer division per element.
template <int N, typename F>
__device__ __forceinline__ void for_pieces(int pieces, F&& f) {
  if ((pieces & (pieces - 1)) == 0 && pieces <= THREADS) {
    const int sh = __ffs(pieces) - 1;
    const int c = threadIdx.x & (pieces - 1);
#pragma unroll 8
    for (int r = threadIdx.x >> sh; r < N; r += THREADS >> sh) f(r, c);
  } else {
    for (int i = threadIdx.x; i < N * pieces; i += THREADS) {
      const int r = i / pieces;
      f(r, i - r * pieces);
    }
  }
}

// Rows [r0, r0 + N) of one head's (S, D) matrix into dst (row stride ld),
// columns [0, D); rows at or past S as zeros. vec (src 16-byte aligned,
// D * sizeof(T) % 16 == 0): 16-byte cp.async; else 4-byte cp.async (f32)
// or plain loads and stores (bf16), which the barrier before their use
// makes visible like the copies.
template <int N, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int r0, int S, int D, bool vec) {
  const int ok_rows = min(N, S - r0);
  if (vec) {
    constexpr int EPC = 16 / (int)sizeof(T);
    for_pieces<N>(D / EPC, [&](int r, int c) {
      const bool ok = r < ok_rows;
      cp_async16(dst + r * ld + c * EPC,
                 src + (size_t)(ok ? r0 + r : 0) * D + c * EPC, ok ? 16 : 0);
    });
    return;
  }
  for_pieces<N>(D, [&](int r, int c) {
    const bool ok = r < ok_rows;
    const T* from = src + (size_t)(ok ? r0 + r : 0) * D + c;
    if constexpr (sizeof(T) == 4)
      cp_async4(dst + r * ld + c, from, ok ? 4 : 0);
    else
      dst[r * ld + c] = ok ? *from : zero<T>();
  });
}

// Columns [c0, c1) of N rows (row stride ld) as zeros: the depth padding
// of the tiles copy_rows fills (it writes [0, D) only, so once is enough).
template <int N, typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ld, int c0, int c1) {
  for_pieces<N>(c1 - c0,
                [&](int r, int c) { dst[r * ld + c0 + c] = zero<T>(); });
}

// (v0, v1) as three bf16x2 planes hi, mid, lo: the same values as
// mma_tile.cuh's split_pair (hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid); exact while lo is normal), with one packed
// conversion per plane instead of one per value.
__device__ __forceinline__ void split_x2(float v0, float v1, uint32_t& hi,
                                         uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bf162_bits(h);
  mid = bf162_bits(m);
  lo = bf162_bits(__floats2bfloat162_rn(r0 - __low2float(m),
                                        r1 - __high2float(m)));
}

// The f32 rows [0, N) x [0, dp) of src (row stride dp) as NPL bf16 planes
// at dst + p * pstride (row stride ld_bf16(dp)): NPL 3 gives hi, mid, lo
// (their sum is the value); NPL 2 gives hi and bf16(x - hi), within
// 2^-16 |x| of it.
template <int NPL, int N>
__device__ __forceinline__ void split_rows(__nv_bfloat16* dst, int pstride,
                                           const float* src, int dp) {
  const int ld = ld_bf16(dp);
  for_pieces<N>(dp / 4, [&](int r, int c4) {
    const int c = 4 * c4;
    const float4 v = *reinterpret_cast<const float4*>(src + r * dp + c);
    uint32_t p[3][2];
    split_x2(v.x, v.y, p[0][0], p[1][0], p[2][0]);
    split_x2(v.z, v.w, p[0][1], p[1][1], p[2][1]);
#pragma unroll
    for (int pl = 0; pl < NPL; ++pl)
      *reinterpret_cast<uint2*>(dst + pl * pstride + r * ld + c) =
          make_uint2(p[pl][0], p[pl][1]);
  });
}

// ------------------------------------------------------------ score tile

template <typename T>
__host__ __device__ constexpr int planes() {
  return sizeof(T) == 4 ? 3 : 1;
}

// The warp's A fragments (rows g and g + 8 of its 16, physical depth
// 4t..4t+3) of one k16 step, each row at row0 / row1: bf16 as it is, f32
// as planes hi, mid, lo.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&af)[planes<T>()][4],
                                       const T* row0, const T* row1) {
  if constexpr (sizeof(T) == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(row0);
    const uint2 y = *reinterpret_cast<const uint2*>(row1);
    af[0][0] = x.x;
    af[0][1] = y.x;
    af[0][2] = x.y;
    af[0][3] = y.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(row0);
    const float4 y = *reinterpret_cast<const float4*>(row1);
    split_x2(x.x, x.y, af[0][0], af[1][0], af[2][0]);
    split_x2(y.x, y.y, af[0][1], af[1][1], af[2][1]);
    split_x2(x.z, x.w, af[0][2], af[1][2], af[2][2]);
    split_x2(y.z, y.w, af[0][3], af[1][3], af[2][3]);
  }
}

// acc[j] += A . B over one k16 step, B = rows [8j, 8j + 8) of the streamed
// tile at b (this lane's row and depth already applied; for f32 inputs
// its three planes, pstride apart).
template <int PL, int NB>
__device__ __forceinline__ void mma_step(float (&acc)[NB][4],
                                         const uint32_t (&af)[PL][4],
                                         const __nv_bfloat16* b, int ldb,
                                         int pstride) {
  if constexpr (PL == 1) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint2 bb = *reinterpret_cast<const uint2*>(b + 8 * j * ldb);
      mma_bf16(acc[j], af[0], bb.x, bb.y);
    }
  } else {
    uint2 bf[NB][3];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        bf[j][pl] = *reinterpret_cast<const uint2*>(b + pl * pstride +
                                                    8 * j * ldb);
    // product-major, so the NB accumulators' chains interleave; the
    // smallest products first: lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
    // hi.hi (A plane, B plane)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(acc[j], af[2], bf[j][0].x, bf[j][0].y);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(acc[j], af[0], bf[j][2].x, bf[j][2].y);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(acc[j], af[1], bf[j][1].x, bf[j][1].y);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(acc[j], af[1], bf[j][0].x, bf[j][0].y);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(acc[j], af[0], bf[j][1].x, bf[j][1].y);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(acc[j], af[0], bf[j][0].x, bf[j][0].y);
  }
}

// The warp's 16 rows of the resident tile a (row stride lda) and its B
// rows of the streamed tile b (row stride ldb), offset to this lane.
template <typename T>
__device__ __forceinline__ const T* lane_row(const T* a, int lda) {
  const int lane = threadIdx.x % 32;
  return a + (16 * (threadIdx.x / 32) + (lane >> 2)) * lda + 4 * (lane & 3);
}
__device__ __forceinline__ const __nv_bfloat16* lane_col(
    const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32;
  return b + (lane >> 2) * ldb + 4 * (lane & 3);
}

// acc[j] += the scores of the warp's 16 rows of the resident tile a (row
// stride lda) against rows [8j, 8j + 8) of the streamed tile b (bf16,
// row stride ldb; for f32 inputs its three planes, pstride apart), over
// depth [0, 16 * ksteps), ksteps <= KMAX. A is loaded (and split) here.
template <typename T, int NB, int KMAX>
__device__ __forceinline__ void score_tile(float (&acc)[NB][4], const T* a,
                                           int lda,
                                           const __nv_bfloat16* b, int ldb,
                                           int pstride, int ksteps) {
  const T* a0 = lane_row(a, lda);
  const __nv_bfloat16* b0 = lane_col(b, ldb);
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s >= ksteps) break;                      // block-uniform
    uint32_t af[planes<T>()][4];
    load_a<T>(af, a0 + 16 * s, a0 + 8 * lda + 16 * s);
    mma_step<planes<T>(), NB>(acc, af, b0 + 16 * s, ldb, pstride);
  }
}

// The same with the warp's A fragments of every k16 step already in
// registers (af, from load_a once per block: the resident tile's rows do
// not change), where they fit.
template <int PL, int NB, int KMAX>
__device__ __forceinline__ void score_tile(float (&acc)[NB][4],
                                           const uint32_t (&af)[KMAX][PL][4],
                                           const __nv_bfloat16* b, int ldb,
                                           int pstride, int ksteps) {
  const __nv_bfloat16* b0 = lane_col(b, ldb);
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s >= ksteps) break;                      // block-uniform
    mma_step<PL, NB>(acc, af[s], b0 + 16 * s, ldb, pstride);
  }
}

// Every k16 step's A fragments of the warp's rows of a (row stride lda),
// for the register-resident score_tile.
template <typename T, int KMAX>
__device__ __forceinline__ void load_rows_a(
    uint32_t (&af)[KMAX][planes<T>()][4], const T* a, int lda, int ksteps) {
  const T* a0 = lane_row(a, lda);
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < ksteps) {
      load_a<T>(af[s], a0 + 16 * s, a0 + 8 * lda + 16 * s);
    } else {
#pragma unroll
      for (int pl = 0; pl < planes<T>(); ++pl)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[s][pl][e] = 0u;
    }
  }
}

// 2^x on the SFU (ex2.approx: relative error below 2^-22; results under
// 2^-126 flush to 0, far below the 1e-4 tolerance of any sum they enter)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ P · V helpers

// (p0, p1) as two bf16x2 planes: hi = bf16(p), lo = bf16(p - hi); hi + lo
// is within 2^-16 p of p (one bf16 plane would be 2^-8: ~2e-3 on out).
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = bf162_bits(h);
  lo = bf162_bits(__floats2bfloat162_rn(p0 - __low2float(h),
                                        p1 - __high2float(h)));
}

// four 8x8 bf16 matrices, transposed: the B fragments of a row-major
// (k, n) tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

}  // namespace attn
