// K1: fused dual-precision grouped expert matmul with live-row watermarks,
// on Hopper's tensor cores.
//
// Replaces the TPU kernel expert_quant_matmul_grouped_pallas
// (src/repro/kernels/quant_matmul/expert_quant_matmul.py, bodies
// _grouped_dual_kernel and _grouped_skip_kernel). One launch computes, for
// every expert e of a combined capacity buffer x (E, cap_hi + cap_lo, K):
//   y[e, :cap_hi] = x[e, :cap_hi] @ dequant(hi_e)
//   y[e, cap_hi:] = x[e, cap_hi:] @ dequant(lo_e)
// Rows at or past the (expert, precision) watermark counts[e, p] (clipped
// to the region's capacity) are written as exact zeros; their activations
// and codes are never read. "4/0" (no lo store) runs one region.
//
// What bounds it on an H100, and the design (mma_tile.cuh):
//  * Decode (a region of at most a few live rows, cap 4-8) is bound by the
//    code bytes (1 MiB of 4-bit or 512 KiB of 2-bit codes plus 128 KiB of
//    scales per OLMoE matrix and expert). It wants many blocks and many
//    bytes in flight: where no region holds more than 16 rows, blocks of
//    one m16 tile (MT = 1: 128 registers a thread and 29-34 KiB of
//    shared memory, so 4 blocks an SM), one per (128-column tile, expert,
//    region): 1024-2048 blocks for OLMoE, each streaming its codes once
//    through a 2-stage cp.async ring.
//  * Admission waves (cap 320 rows per region) are bound by operations:
//    exact bf16 mma.sync on the integer codes (three MMAs per step for f32
//    x), 64-row tiles (MT = 4), so each code a block stages feeds 64 rows.
//  * The rows split over a grid dimension sized from the capacity (shapes
//    only): ceil(max(cap_hi, cap_lo) / (16 MT)) row tiles, not a row loop
//    in the block. A loop would keep one block's accumulators for every row
//    tile of a column tile or restage its codes per tile; the grid
//    dimension puts the row tiles of one (column tile, expert) next to each
//    other in launch order, so their code reads after the first hit L2. A
//    tile at or past the watermark only writes its zeros and returns.
// The watermark is read from device memory inside the block: no host sync.
#include "mma_tile.cuh"

namespace eqm_mma {

using namespace mmt;

// MT = 1 (decode) is held to 128 registers a thread so 4 blocks fit an SM
// (without spills); MT = 4 needs its 128 accumulator registers and more.
template <typename Tin, int MT>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 4 : 1)
grouped_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ hp,
               const float* __restrict__ hs, const uint8_t* __restrict__ lp,
               const float* __restrict__ ls, const int* __restrict__ counts,
               void* __restrict__ out, int out_bf16, int M, int K, int N,
               int cap_hi, int hi_bits, int lo_bits, int gs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int regions = lp != nullptr ? 2 : 1;
  const int e = blockIdx.z / regions;
  const int p = blockIdx.z - e * regions;    // 0: hi region, 1: lo region
  const int cap = p == 0 ? cap_hi : M - cap_hi;
  constexpr int BM = 16 * MT;
  const int tile0 = blockIdx.x * BM;
  if (tile0 >= cap) return;                  // past this region's capacity
  const int rows = min(BM, cap - tile0);
  const int wm = max(0, min(counts[2 * e + p], cap));
  const int live = max(0, min(wm - tile0, rows));
  const int n0 = blockIdx.y * BN;
  const size_t row_base = (size_t)e * M + (p == 0 ? 0 : cap_hi) + tile0;
  zero_rows(out, out_bf16, row_base + live, rows - live, N, n0);
  if (live == 0) return;
  const int bits = p == 0 ? hi_bits : lo_bits;
  const size_t kp = (size_t)K * bits / 8;
  region_tile_bits<Tin, MT>(
      bits, smem, x + row_base * K, live, K, N,
      (p == 0 ? hp : lp) + (size_t)e * N * kp,
      (p == 0 ? hs : ls) + (size_t)e * (K / gs) * N, gs,
      out_at(out, out_bf16, row_base * N), out_bf16, n0);
}

template <typename Tin, int MT>
static int launch(const void* x, const void* hp, const void* hs,
                  const void* lp, const void* ls, const void* counts,
                  void* out, int out_bf16, int E, int M, int K, int N,
                  int cap_hi, int hi_bits, int lo_bits, int gs,
                  cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_kernel<Tin, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const int regions = lp != nullptr ? 2 : 1;
  const int cap_max = max(cap_hi, M - cap_hi);
  dim3 grid((cap_max + 16 * MT - 1) / (16 * MT), (N + BN - 1) / BN,
            E * regions);
  grouped_kernel<Tin, MT><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(hp),
      static_cast<const float*>(hs), static_cast<const uint8_t*>(lp),
      static_cast<const float*>(ls), static_cast<const int*>(counts), out,
      out_bf16, M, K, N, cap_hi, hi_bits, lo_bits, gs);
  return (int)cudaGetLastError();
}

}  // namespace eqm_mma

// Plain C entry point for ctypes. x_bf16 / out_bf16 select bf16 (1) or f32
// (0). lp/ls are null under "4/0". Returns the CUDA error of the launch (0
// on success); the Python wrapper raises on anything else.
extern "C" int eqm_grouped_launch(const void* x, int x_bf16, const void* hp,
                                  const void* hs, const void* lp,
                                  const void* ls, const void* counts,
                                  void* out, int out_bf16, int E, int M,
                                  int K, int N, int cap_hi, int hi_bits,
                                  int lo_bits, int gs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one m16 tile a block where no region holds more than 16 rows (decode)
  const bool small = cap_hi <= 16 && M - cap_hi <= 16;
  if (x_bf16)
    return small ? eqm_mma::launch<__nv_bfloat16, 1>(
                       x, hp, hs, lp, ls, counts, out, out_bf16, E, M, K, N,
                       cap_hi, hi_bits, lo_bits, gs, s)
                 : eqm_mma::launch<__nv_bfloat16, 4>(
                       x, hp, hs, lp, ls, counts, out, out_bf16, E, M, K, N,
                       cap_hi, hi_bits, lo_bits, gs, s);
  return small ? eqm_mma::launch<float, 1>(x, hp, hs, lp, ls, counts, out,
                                           out_bf16, E, M, K, N, cap_hi,
                                           hi_bits, lo_bits, gs, s)
               : eqm_mma::launch<float, 4>(x, hp, hs, lp, ls, counts, out,
                                           out_bf16, E, M, K, N, cap_hi,
                                           hi_bits, lo_bits, gs, s);
}

// Resources of instantiation `which`, in the order of
// INSTANTIATIONS["eqm_grouped"] in repro_torch/analysis/resources.py:
// out = {numRegs, localSizeBytes, sharedSizeBytes,
// maxDynamicSharedSizeBytes, requested dynamic shared memory}.
extern "C" int eqm_grouped_attrs(int which, int* out) {
  switch (which) {
    case 0: return mmt::func_attrs(eqm_mma::grouped_kernel<__nv_bfloat16, 1>,
                                 mmt::smem_bytes<__nv_bfloat16, 1>(), out);
    case 1: return mmt::func_attrs(eqm_mma::grouped_kernel<__nv_bfloat16, 4>,
                                 mmt::smem_bytes<__nv_bfloat16, 4>(), out);
    case 2: return mmt::func_attrs(eqm_mma::grouped_kernel<float, 1>,
                                 mmt::smem_bytes<float, 1>(), out);
    case 3: return mmt::func_attrs(eqm_mma::grouped_kernel<float, 4>,
                                 mmt::smem_bytes<float, 4>(), out);
  }
  return (int)cudaErrorInvalidValue;
}
