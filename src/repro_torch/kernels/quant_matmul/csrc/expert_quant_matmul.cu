// K2: grouped expert matmul at a per-expert precision picked by a
// critical mask read inside the kernel, on Hopper's tensor cores.
//
// Replaces the TPU kernel expert_quant_matmul_pallas
// (src/repro/kernels/quant_matmul/expert_quant_matmul.py, bodies
// _dual_kernel and _skip_kernel). For x (E, M, K) and critical (E,):
//   y[e] = x[e] @ dequant(critical[e] ? hi_e : lo_e)
// The store an expert does not use is never read. Under "4/0" (no lo
// store) a sub-critical expert's rows are written as exact zeros, and
// neither its codes nor its x rows are read. Every row of a running
// expert is live: the dispatch zero-fills the padded slots of its
// capacity buffer, as the JAX package does.
//
// What bounds it on an H100, and the design (mma_tile.cuh, as K1):
//  * The solo admission prefill (M = _capacity(cfg, S) rows, 80 for a
//    512-token OLMoE prompt) is a skinny GEMM per expert: 4*M operations
//    per 4-bit code byte, 320 at M = 80, about the bf16 tensor-core ridge
//    of 295, so bytes and operations bound it about equally. Exact bf16
//    mma.sync on the integer codes (three MMAs per step for f32 x), row
//    tiles of 64 (MT = 4) so each staged code feeds 64 rows. A ragged last
//    tile of at most 16 rows (M = 80: 64 + 16) runs the one-m16 routine
//    instead of issuing MMAs for 64 rows.
//  * At M <= 16 (a 64-token admission, M = 10; the fixed-precision
//    decode entry point) it is bound by the code bytes, as K1's decode:
//    blocks of one m16 tile (MT = 1, 4 blocks an SM), 512-1024 blocks for
//    OLMoE's 64 experts, each streaming its codes once through the 2-stage
//    cp.async ring.
//  * Grid (row tile, 128-column tile, expert), sized from shapes only; the
//    row tiles of one (column tile, expert) run next to each other, so
//    their code reads after the first hit L2. The mask is read from device
//    memory inside the block: no host sync.
#include "mma_tile.cuh"

namespace eqm_mma {

using namespace mmt;

template <typename Tin, int MT>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 4 : 1)
expert_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ hp,
              const float* __restrict__ hs, const uint8_t* __restrict__ lp,
              const float* __restrict__ ls, const int* __restrict__ crit,
              void* __restrict__ out, int out_bf16, int M, int K, int N,
              int hi_bits, int lo_bits, int gs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int e = blockIdx.z;
  const int tile0 = blockIdx.x * 16 * MT;
  const int rows = min(16 * MT, M - tile0);
  const int n0 = blockIdx.y * BN;
  const size_t row_base = (size_t)e * M + tile0;
  const bool hi = crit[e] > 0;
  if (!hi && lp == nullptr) {                  // "4/0": skipped expert
    zero_rows(out, out_bf16, row_base, rows, N, n0);
    return;
  }
  const int bits = hi ? hi_bits : lo_bits;
  const size_t kp = (size_t)K * bits / 8;
  const uint8_t* packed = (hi ? hp : lp) + (size_t)e * N * kp;
  const float* scales = (hi ? hs : ls) + (size_t)e * (K / gs) * N;
  row_tile<Tin, MT>(bits, smem, x + row_base * K, rows, K, N, packed,
                    scales, gs, out_at(out, out_bf16, row_base * N),
                    out_bf16, n0);
}

template <typename Tin, int MT>
static int launch(const void* x, const void* hp, const void* hs,
                  const void* lp, const void* ls, const void* crit,
                  void* out, int out_bf16, int E, int M, int K, int N,
                  int hi_bits, int lo_bits, int gs, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      expert_kernel<Tin, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((M + 16 * MT - 1) / (16 * MT), (N + BN - 1) / BN, E);
  expert_kernel<Tin, MT><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(hp),
      static_cast<const float*>(hs), static_cast<const uint8_t*>(lp),
      static_cast<const float*>(ls), static_cast<const int*>(crit), out,
      out_bf16, M, K, N, hi_bits, lo_bits, gs);
  return (int)cudaGetLastError();
}

}  // namespace eqm_mma

// Plain C entry point for ctypes; see eqm_grouped_launch for the
// conventions. crit is an int32 (E,) mask on the device.
extern "C" int eqm_expert_launch(const void* x, int x_bf16, const void* hp,
                                 const void* hs, const void* lp,
                                 const void* ls, const void* crit, void* out,
                                 int out_bf16, int E, int M, int K, int N,
                                 int hi_bits, int lo_bits, int gs,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one m16 tile a block where an expert holds at most 16 rows
  const bool small = M <= 16;
  if (x_bf16)
    return small ? eqm_mma::launch<__nv_bfloat16, 1>(
                       x, hp, hs, lp, ls, crit, out, out_bf16, E, M, K, N,
                       hi_bits, lo_bits, gs, s)
                 : eqm_mma::launch<__nv_bfloat16, 4>(
                       x, hp, hs, lp, ls, crit, out, out_bf16, E, M, K, N,
                       hi_bits, lo_bits, gs, s);
  return small ? eqm_mma::launch<float, 1>(x, hp, hs, lp, ls, crit, out,
                                           out_bf16, E, M, K, N, hi_bits,
                                           lo_bits, gs, s)
               : eqm_mma::launch<float, 4>(x, hp, hs, lp, ls, crit, out,
                                           out_bf16, E, M, K, N, hi_bits,
                                           lo_bits, gs, s);
}
