// K5: per-key received attention mass, DyMoE Eq. 1.
//
// Replaces the TPU kernel key_mass_pallas
// (src/repro/kernels/attn_scores/attn_scores.py, body _mass_kernel). For
// q, k (H, S, D), the per-query lse (H, S) of K4 and scale 1/sqrt(D):
//   mass[h, j] = sum_i exp(s_ij - lse[h, i])
// with s_ij = scale q_i . k_j, and under `causal` s_ij = -1e30 for j > i.
// With the lse known every normalised probability is recomputable on its
// own, so the S x S matrix never exists.
//
// What bounds it on an H100: 2 H S^2 D f32 operations (half of it under
// causal) against 2 H S D elements read: bound by f32 operations on the
// CUDA cores. The design: grid (ceil(S / 64), H), one block per (key tile,
// head); the block keeps its key tile in shared memory and loops over the
// query tiles on or below the diagonal (all of them without `causal`),
// which takes the place of the TPU grid's sequential query axis. Each
// thread sums its 4 columns over its rows in registers, and the block
// adds the 16 partial sums of a column in a fixed order at the end: the
// block owns its columns, so there are no atomics and the result is the
// same on every run. Queries and keys past S are masked in the kernel.
#include "attn_tile.cuh"

namespace attn {

template <typename T>
__global__ void __launch_bounds__(THREADS)
key_mass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const float* __restrict__ lse, float* __restrict__ mass,
                int S, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sk = smem;                   // [BK][ld]
  float* sq = sk + BK * ld;           // [BQ][ld]
  float* sl = sq + BQ * ld;           // [BQ] lse of the query tile
  float* red = sl + BQ;               // [16][BK] partial column sums
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t head = (size_t)h * S * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_rows(sk, ld, k + head, k0, S, D);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // BQ == BK: the first query tile with a query at or below key k0 is k0's
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += BQ) {
    __syncthreads();           // the previous tile's sq, sl are read
    load_rows(sq, ld, q + head, q0, S, D);
    if (tid < BQ) sl[tid] = q0 + tid < S ? lse[(size_t)h * S + q0 + tid] : 0.f;
    __syncthreads();
    float s[4][4];
    score_tile(sq, sk, ld, D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi >= S) continue;                   // no such query
      const float l = sl[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float val = causal && kj > qi ? NEG : s[i][j] * scale;
        acc[j] += expf(val - l);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * BK + tx + 16 * j] = acc[j];
  __syncthreads();
  if (tid < BK && k0 + tid < S) {
    float total = 0.f;
    for (int r = 0; r < 16; ++r) total += red[r * BK + tid];
    mass[(size_t)h * S + k0 + tid] = total;
  }
}

template <typename T>
static int launch(const void* q, const void* k, const float* lse,
                  float* mass, int H, int S, int D, int causal, float scale,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BQ +
                                       16 * BK);
  cudaError_t err = cudaFuncSetAttribute(
      key_mass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BK - 1) / BK, H, 1);
  key_mass_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lse, mass, S, D,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace attn

// Plain C entry point for ctypes. in_bf16 selects bf16 (1) or f32 (0) q/k;
// lse and mass are f32. Needs 1 <= D <= 256 (the wrapper checks). Returns
// the first CUDA error of the launch (0 on success); the Python wrapper
// raises on anything else.
extern "C" int key_mass_launch(const void* q, const void* k, int in_bf16,
                               const void* lse, void* mass, int H, int S,
                               int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* m = static_cast<float*>(mass);
  if (in_bf16)
    return attn::launch<__nv_bfloat16>(q, k, l, m, H, S, D, causal, scale, s);
  return attn::launch<float>(q, k, l, m, H, S, D, causal, scale, s);
}
