// Shared block routine of the packed-weight matmul kernels
// (expert_quant_matmul_grouped.cu, expert_quant_matmul.cu, quant_matmul.cu).
//
// One thread block owns one (expert, precision region, BN-column tile) of
// y = x @ dequant(packed, scales) and walks the region's LIVE rows in
// register tiles of BM rows; each tile walks K in BK-deep chunks staged in
// shared memory. This loop over K inside the block takes the place of the
// TPU kernel's sequential K grid axis and its VMEM accumulator.
//
// Layouts (as the JAX package stores them):
//   x       (rows, K)        f32 or bf16, K contiguous
//   packed  (N, K / vpb)     uint8, offset-coded codes packed along K:
//                            value j of a byte sits at bit bits*j and
//                            decodes as ((byte >> bits*j) & mask) - 2^(bits-1)
//   scales  (K / gs, N)      f32, N contiguous
//   out     (rows, N)        f32 or bf16
//
// The codes of a chunk are read as 32-bit words, 8 consecutive threads per
// output column, so a warp reads four contiguous 32-byte sectors. Each
// word is unpacked and scaled once into the shared f32 weight tile and
// then reused by every live row of the register tile: for a decode region
// (live rows <= BM) the codes of a (expert, precision, column tile) are
// read from device memory exactly once. Rows at or past the region's
// live-row watermark are never computed: the block writes them as zeros
// (the output comes from torch.empty) and never reads their activations.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace eqm {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // K depth of one staged chunk
constexpr int BM = 32;        // rows of one register tile
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;        // 4: warp-uniform row group
constexpr int RPT = BM / ROW_GROUPS;            // 8 rows per thread
static_assert(RPT == 8, "region_tile's mac_rows switch covers 1..8 rows");

struct Smem {
  float w[BK][BN + 1];        // dequantized weight tile, [k][n]
  float x[BM][BK];            // activation tile, [row][k]
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage chunk [k0, k0+BK) x columns [n0, n0+BN) of dequant(packed, scales)
// into sm.w. Requires group_size % (32 / BITS) == 0 so one 32-bit word of
// codes lies inside one scale group, and (K / vpb) % 4 == 0 so every word
// is aligned (the wrapper checks both).
template <int BITS>
__device__ __forceinline__ void stage_weights(Smem& sm, const uint8_t* packed,
                                              const float* scales, int K,
                                              int N, int gs, int n0, int k0) {
  constexpr int VPW = 32 / BITS;               // values per 32-bit word
  constexpr int WPC = BK / VPW;                // words per column per chunk
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int OFFSET = 1 << (BITS - 1);
  const int kp_words = K / VPW;                // words per packed row
  for (int w = threadIdx.x; w < BN * WPC; w += THREADS) {
    const int col = w / WPC;
    const int wi = w - col * WPC;
    const int n = n0 + col;
    const int kb = k0 + wi * VPW;
    const int kk = wi * VPW;
    if (n < N && kb < K) {
      const uint32_t word = __ldg(
          reinterpret_cast<const uint32_t*>(packed) + (size_t)n * kp_words +
          kb / VPW);
      const float s = __ldg(scales + (size_t)(kb / gs) * N + n);
#pragma unroll
      for (int v = 0; v < VPW; ++v) {
        const int q = (int)((word >> (BITS * v)) & MASK) - OFFSET;
        sm.w[kk + v][col] = (float)q * s;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VPW; ++v) sm.w[kk + v][col] = 0.f;
    }
  }
}

// acc[i] += x[rg + ROW_GROUPS*i, :] . w[:, col] over the staged chunk, for
// the R rows this thread owns. R is a template constant so a decode tile
// (one row per thread) issues no instructions for rows that are not there.
template <int R>
__device__ __forceinline__ void mac_rows(const Smem& sm, int rg, int col,
                                         float* acc) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    const float wv = sm.w[kk][col];
#pragma unroll
    for (int i = 0; i < R; ++i)
      acc[i] = fmaf(sm.x[rg + ROW_GROUPS * i][kk], wv, acc[i]);
  }
}

// out[r, n] = sum_k x[r, k] * dequant(packed, scales)[k, n] for the block's
// column tile, r < live_rows; rows [live_rows, total_rows) are written as
// zeros without touching codes or activations. live_rows is block-uniform.
template <typename Tin, typename Tout>
__device__ void region_tile(Smem& sm, const Tin* x, int live_rows,
                            int total_rows, int K, int N,
                            const uint8_t* packed, const float* scales,
                            int bits, int gs, Tout* out, int n0) {
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;   // warp-uniform: BN is a multiple of 32
  for (int r0 = 0; r0 < live_rows; r0 += BM) {
    const int nrows = min(BM, live_rows - r0);
    // rows of this tile owned by this thread's (warp-uniform) row group
    const int mine = rg < nrows ? (nrows - rg + ROW_GROUPS - 1) / ROW_GROUPS
                                : 0;
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int idx = tid; idx < nrows * BK; idx += THREADS) {
        const int r = idx / BK;
        const int kk = idx - r * BK;
        const int k = k0 + kk;
        sm.x[r][kk] = k < K ? to_f32(x[(size_t)(r0 + r) * K + k]) : 0.f;
      }
      if (bits == 4)
        stage_weights<4>(sm, packed, scales, K, N, gs, n0, k0);
      else if (bits == 2)
        stage_weights<2>(sm, packed, scales, K, N, gs, n0, k0);
      else
        stage_weights<8>(sm, packed, scales, K, N, gs, n0, k0);
      __syncthreads();
      switch (mine) {                        // warp-uniform
        case 1: mac_rows<1>(sm, rg, col, acc); break;
        case 2: mac_rows<2>(sm, rg, col, acc); break;
        case 3: mac_rows<3>(sm, rg, col, acc); break;
        case 4: mac_rows<4>(sm, rg, col, acc); break;
        case 5: mac_rows<5>(sm, rg, col, acc); break;
        case 6: mac_rows<6>(sm, rg, col, acc); break;
        case 7: mac_rows<7>(sm, rg, col, acc); break;
        case 8: mac_rows<8>(sm, rg, col, acc); break;
        default: break;
      }
      __syncthreads();
    }
    const int n = n0 + col;
    if (n < N) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + ROW_GROUPS * i;
        if (r < nrows) store(out + (size_t)(r0 + r) * N + n, acc[i]);
      }
    }
  }
  const int dead = total_rows - live_rows;
  for (int idx = tid; idx < dead * BN; idx += THREADS) {
    const int r = live_rows + idx / BN;
    const int n = n0 + idx % BN;
    if (n < N) store(out + (size_t)r * N + n, 0.f);
  }
}

}  // namespace eqm
