// K3: dense matmul against one packed weight store, y = x @ dequant(W).
//
// Replaces the TPU kernel quant_matmul_pallas
// (src/repro/kernels/quant_matmul/quant_matmul.py, body _kernel). For
// x (M, K), packed (N, K / vpb) uint8 at 2, 4 or 8 bits and scales
// (K / gs, N) f32:   y = x @ dequant(packed, scales), f32 accumulate.
//
// What bounds it on an H100: at a decode row (M = 1) it reads K*N*bits/8
// code bytes for 2*K*N FLOPs, 4 FLOPs per 4-bit code byte, far below the
// f32 CUDA-core ridge of about 20: bound by the bytes of the codes. At a
// prefill (M in the hundreds) it is bound by f32 operations (x is widened
// to f32, as in the reference). The design is the block routine the two
// expert kernels share (dequant_tile.cuh) with one expert and one
// precision: grid (N / BN, ceil(M / BM)), one block per (column tile, row
// tile); the block unpacks each BK-deep chunk of its codes once into a
// shared f32 tile and reuses it for all rows of its tile, and the inner
// loop is specialised on the rows a thread owns (mac_rows<R>), so a
// decode row runs the FMAs of one row only. Tensor cores (wgmma) would
// lift the compute roof of a prefill; that is later work.
#include "dequant_tile.cuh"

namespace eqm {

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
dense_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ packed,
             const float* __restrict__ scales, Tout* __restrict__ out, int M,
             int K, int N, int bits, int gs) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int rows = min(BM, M - r0);
  region_tile<Tin, Tout>(sm, x + (size_t)r0 * K, rows, rows, K, N, packed,
                         scales, bits, gs, out + (size_t)r0 * N, n0);
}

template <typename Tin, typename Tout>
static void launch_dense(const void* x, const void* packed,
                         const void* scales, void* out, int M, int K, int N,
                         int bits, int gs, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  dense_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<Tout*>(out), M, K, N,
      bits, gs);
}

}  // namespace eqm

// Plain C entry point for ctypes. x_bf16 / out_bf16 select bf16 (1) or f32
// (0). Returns cudaGetLastError() after the launch (0 on success); the
// Python wrapper raises on anything else.
extern "C" int qm_dense_launch(const void* x, int x_bf16, const void* packed,
                               const void* scales, void* out, int out_bf16,
                               int M, int K, int N, int bits, int gs,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    eqm::launch_dense<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, out, M,
                                                    K, N, bits, gs, s);
  else if (x_bf16)
    eqm::launch_dense<__nv_bfloat16, float>(x, packed, scales, out, M, K, N,
                                            bits, gs, s);
  else if (out_bf16)
    eqm::launch_dense<float, __nv_bfloat16>(x, packed, scales, out, M, K, N,
                                            bits, gs, s);
  else
    eqm::launch_dense<float, float>(x, packed, scales, out, M, K, N, bits, gs,
                                    s);
  return (int)cudaGetLastError();
}
