// K1: fused dual-precision grouped expert matmul with live-row watermarks.
//
// Replaces the TPU kernel expert_quant_matmul_grouped_pallas
// (src/repro/kernels/quant_matmul/expert_quant_matmul.py, bodies
// _grouped_dual_kernel and _grouped_skip_kernel). One launch computes, for
// every expert e of a combined capacity buffer x (E, cap_hi + cap_lo, K):
//   y[e, :cap_hi] = x[e, :cap_hi] @ dequant(hi_e)
//   y[e, cap_hi:] = x[e, cap_hi:] @ dequant(lo_e)
// Rows at or past the (expert, precision) watermark counts[e, p] (clipped
// to the region's capacity) are written as zeros and cost no codes, no
// activations and no FLOPs. "4/0" (no lo store) runs one precision group.
//
// What bounds it on an H100: weight bandwidth. A decode region holds at
// most live_cap rows (<= the slot count), far fewer than a tensor-core
// tile, so each live (expert, precision) group must stream its codes
// (1 MiB of 4-bit or 512 KiB of 2-bit codes plus 128 KiB of f32 scales per
// OLMoE matrix) and reuse them for all its rows. The design: grid
// (N / BN, E, P), one block per (column tile, expert, precision); the
// watermark is read from device memory inside the block (no host sync, no
// grid sized from it), dead groups only write zeros, and a live group's
// codes are unpacked once per BM-row tile into shared memory and reused by
// every row of it. Arithmetic is f32 on the CUDA cores (x widened to f32,
// f32 accumulate), matching the reference's true-f32 dot; admission-wave
// regions (hundreds of rows) are compute-heavy and would want wgmma.
#include "dequant_tile.cuh"

namespace eqm {

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
grouped_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ hp,
               const float* __restrict__ hs, const uint8_t* __restrict__ lp,
               const float* __restrict__ ls, const int* __restrict__ counts,
               Tout* __restrict__ out, int M, int K, int N, int cap_hi,
               int hi_bits, int lo_bits, int gs) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.y;
  const int p = blockIdx.z;           // 0: hi region, 1: lo region
  const int cap = p == 0 ? cap_hi : M - cap_hi;
  const int row0 = p == 0 ? 0 : cap_hi;
  const int wm = max(0, min(counts[2 * e + p], cap));
  const int bits = p == 0 ? hi_bits : lo_bits;
  const uint8_t* packed = p == 0 ? hp : lp;
  const float* scales = p == 0 ? hs : ls;
  const size_t kp = (size_t)K * bits / 8;
  region_tile<Tin, Tout>(sm, x + ((size_t)e * M + row0) * K, wm, cap, K, N,
                         packed + (size_t)e * N * kp,
                         scales + (size_t)e * (K / gs) * N, bits, gs,
                         out + ((size_t)e * M + row0) * N, n0);
}

template <typename Tin, typename Tout>
static void launch(const void* x, const void* hp, const void* hs,
                   const void* lp, const void* ls, const void* counts,
                   void* out, int E, int M, int K, int N, int cap_hi,
                   int hi_bits, int lo_bits, int gs, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, E, lp != nullptr ? 2 : 1);
  grouped_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(hp),
      static_cast<const float*>(hs), static_cast<const uint8_t*>(lp),
      static_cast<const float*>(ls), static_cast<const int*>(counts),
      static_cast<Tout*>(out), M, K, N, cap_hi, hi_bits, lo_bits, gs);
}

}  // namespace eqm

// Plain C entry point for ctypes. x_bf16 / out_bf16 select bf16 (1) or f32
// (0). lp/ls are null under "4/0". Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int eqm_grouped_launch(const void* x, int x_bf16, const void* hp,
                                  const void* hs, const void* lp,
                                  const void* ls, const void* counts,
                                  void* out, int out_bf16, int E, int M,
                                  int K, int N, int cap_hi, int hi_bits,
                                  int lo_bits, int gs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    eqm::launch<__nv_bfloat16, __nv_bfloat16>(x, hp, hs, lp, ls, counts, out,
                                              E, M, K, N, cap_hi, hi_bits,
                                              lo_bits, gs, s);
  else if (x_bf16)
    eqm::launch<__nv_bfloat16, float>(x, hp, hs, lp, ls, counts, out, E, M,
                                      K, N, cap_hi, hi_bits, lo_bits, gs, s);
  else if (out_bf16)
    eqm::launch<float, __nv_bfloat16>(x, hp, hs, lp, ls, counts, out, E, M,
                                      K, N, cap_hi, hi_bits, lo_bits, gs, s);
  else
    eqm::launch<float, float>(x, hp, hs, lp, ls, counts, out, E, M, K, N,
                              cap_hi, hi_bits, lo_bits, gs, s);
  return (int)cudaGetLastError();
}
