// Shared block routines of the two attention-mass kernels (flash_fwd.cu,
// key_mass.cu).
//
// Layouts (as the JAX package passes them): q, k, v (H, S, D) head-major,
// f32 or bf16, D contiguous; lse and mass (H, S) f32. Everything is
// computed in f32 on the CUDA cores (fmaf, expf), as the reference does.
//
// A block holds 64-row tiles of q and k in shared memory as f32, row
// stride D + 1 so that the 16 rows a warp reads at one d fall in 16
// different banks. Its 256 threads form a 16 x 16 grid; thread (ty, tx)
// owns the 4 x 4 score cells (ty + 16 i, tx + 16 j) of the 64 x 64 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int BQ = 64;          // query rows of a tile
constexpr int BK = 64;          // key rows of a tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;   // the reference's masked logit
constexpr int MAX_D = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows [r0, r0 + 64) of one head's (S, D) matrix into dst[r * ld + d] as
// f32; rows at or past S are zeros (the ragged edge).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int r0, int S, int D) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * ld + d] =
        r0 + r < S ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

// s[i][j] = q[ty + 16 i, :] . k[tx + 16 j, :] over D, from the shared tiles
// sq and sk (row stride ld).
__device__ __forceinline__ void score_tile(const float* sq, const float* sk,
                                           int ld, int D, int ty, int tx,
                                           float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sk[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

}  // namespace attn
