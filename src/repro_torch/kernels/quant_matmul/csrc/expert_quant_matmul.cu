// K2: grouped expert matmul at a per-expert precision picked by a
// critical mask read inside the kernel.
//
// Replaces the TPU kernel expert_quant_matmul_pallas
// (src/repro/kernels/quant_matmul/expert_quant_matmul.py, bodies
// _dual_kernel and _skip_kernel). For x (E, M, K) and critical (E,):
//   y[e] = x[e] @ dequant(critical[e] ? hi_e : lo_e)
// The store an expert does not use is never read. Under "4/0" (no lo
// store) a sub-critical expert's output is written as zeros without its
// codes being unpacked.
//
// What bounds it on an H100: at the solo admission prefill's shapes
// (M = _capacity(cfg, S) rows, 80 for a 512-token OLMoE prompt) each
// expert's matmul is a skinny GEMM: 2*M*K*N FLOPs against K*N*bits/8 code
// bytes, 4*M operations per 4-bit code byte (320 at M = 80), far above the
// f32 CUDA-core ridge of about 20, so it is bound by operations (f32, since
// the reference widens x to f32). The design: grid (N / BN, E), one block per (column
// tile, expert); the mask is read from device memory inside the block (no
// host sync), and the selected precision's codes are unpacked once per
// BM-row tile into shared memory and reused by all rows of the tile, with
// f32 accumulation (x widened to f32, as in the reference). Tensor cores
// (wgmma) would lift the compute roof; that is later work.
#include "dequant_tile.cuh"

namespace eqm {

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
expert_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ hp,
              const float* __restrict__ hs, const uint8_t* __restrict__ lp,
              const float* __restrict__ ls, const int* __restrict__ crit,
              Tout* __restrict__ out, int M, int K, int N, int hi_bits,
              int lo_bits, int gs) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.y;
  const bool hi = crit[e] > 0;
  const bool run = hi || lp != nullptr;
  const int bits = hi ? hi_bits : lo_bits;
  const uint8_t* packed = hi ? hp : lp;
  const float* scales = hi ? hs : ls;
  const size_t kp = run ? (size_t)K * bits / 8 : 0;
  region_tile<Tin, Tout>(sm, x + (size_t)e * M * K, run ? M : 0, M, K, N,
                         run ? packed + (size_t)e * N * kp : nullptr,
                         run ? scales + (size_t)e * (K / gs) * N : nullptr,
                         bits, gs, out + (size_t)e * M * N, n0);
}

template <typename Tin, typename Tout>
static void launch(const void* x, const void* hp, const void* hs,
                   const void* lp, const void* ls, const void* crit,
                   void* out, int E, int M, int K, int N, int hi_bits,
                   int lo_bits, int gs, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, E, 1);
  expert_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(hp),
      static_cast<const float*>(hs), static_cast<const uint8_t*>(lp),
      static_cast<const float*>(ls), static_cast<const int*>(crit),
      static_cast<Tout*>(out), M, K, N, hi_bits, lo_bits, gs);
}

}  // namespace eqm

// Plain C entry point for ctypes; see eqm_grouped_launch for the
// conventions. crit is an int32 (E,) mask on the device.
extern "C" int eqm_expert_launch(const void* x, int x_bf16, const void* hp,
                                 const void* hs, const void* lp,
                                 const void* ls, const void* crit, void* out,
                                 int out_bf16, int E, int M, int K, int N,
                                 int hi_bits, int lo_bits, int gs,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    eqm::launch<__nv_bfloat16, __nv_bfloat16>(x, hp, hs, lp, ls, crit, out,
                                              E, M, K, N, hi_bits, lo_bits,
                                              gs, s);
  else if (x_bf16)
    eqm::launch<__nv_bfloat16, float>(x, hp, hs, lp, ls, crit, out, E, M, K,
                                      N, hi_bits, lo_bits, gs, s);
  else if (out_bf16)
    eqm::launch<float, __nv_bfloat16>(x, hp, hs, lp, ls, crit, out, E, M, K,
                                      N, hi_bits, lo_bits, gs, s);
  else
    eqm::launch<float, float>(x, hp, hs, lp, ls, crit, out, E, M, K, N,
                              hi_bits, lo_bits, gs, s);
  return (int)cudaGetLastError();
}
