// K3: dense matmul against one packed weight store, y = x @ dequant(W), on
// Hopper's tensor cores.
//
// Replaces the TPU kernel quant_matmul_pallas
// (src/repro/kernels/quant_matmul/quant_matmul.py, body _kernel). For
// x (M, K), packed (N, K / vpb) uint8 at 2, 4 or 8 bits and scales
// (K / gs, N) f32:   y = x @ dequant(packed, scales).
//
// What bounds it on an H100, and the design (mma_tile.cuh, as K1 and K2
// with one store and no mask):
//  * A prefill (M in the hundreds) is bound by operations: 4*M operations
//    per 4-bit code byte, far above the bf16 tensor-core ridge of 295 at
//    M = 512. Exact bf16 mma.sync on the integer codes (three MMAs per
//    step for f32 x) in row tiles of 64 (MT = 4), so each staged code
//    feeds 64 rows; a ragged last tile of at most 16 rows runs the one-m16
//    routine.
//  * A decode row (M = 1) or a short chunk (M <= 16) is bound by the code
//    bytes (K*N*bits/8): blocks of one m16 tile (MT = 1, 4 blocks an SM),
//    each streaming its 128 columns' codes once through the 2-stage
//    cp.async ring. At K = N = 2048 that is N / 128 = 16 blocks, each
//    waiting out 32 chunk latencies one after another. So K splits over a
//    grid dimension until every SM has a block (at most 8 splits, in whole
//    scale groups): the splits of one column tile form a thread block
//    cluster, each sums its K range, and rank 0 adds the others' sums,
//    read from their shared memory, in rank order and stores. The result
//    does not depend on which block finishes first, there is no f32
//    atomic and no workspace, and a call stays one launch.
//  * Grid (row tile, 128-column tile[, K split]), sized from shapes and
//    the SM count only.
#include <cooperative_groups.h>

#include <algorithm>
#include <numeric>

#include "mma_tile.cuh"

namespace qm_mma {

using namespace mmt;
namespace cg = cooperative_groups;

template <typename Tin, int MT>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 4 : 1)
dense_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ packed,
             const float* __restrict__ scales, void* __restrict__ out,
             int out_bf16, int M, int K, int N, int bits, int gs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile0 = blockIdx.x * 16 * MT;
  row_tile<Tin, MT>(bits, smem, x + (size_t)tile0 * K,
                    min(16 * MT, M - tile0), K, N, packed, scales, gs,
                    out_at(out, out_bf16, (size_t)tile0 * N), out_bf16,
                    blockIdx.y * BN);
}

template <typename Tin, int MT>
static int launch(const void* x, const void* packed, const void* scales,
                  void* out, int out_bf16, int M, int K, int N, int bits,
                  int gs, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_kernel<Tin, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((M + 16 * MT - 1) / (16 * MT), (N + BN - 1) / BN, 1);
  dense_kernel<Tin, MT><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), out, out_bf16, M, K, N, bits, gs);
  return (int)cudaGetLastError();
}

// y = x @ dequant(W) for M <= 16 rows, split over K: cluster rank s of
// column tile blockIdx.y sums the chunks [s * cps, (s + 1) * cps).
template <typename Tin>
__global__ void __launch_bounds__(THREADS, 4)
dense_split_kernel(const Tin* __restrict__ x,
                   const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales, void* __restrict__ out,
                   int out_bf16, int M, int K, int N, int bits, int gs,
                   int cps) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = rank * cps;
  const int c1 = min((K + BK - 1) / BK, c0 + cps);
  const int n0 = blockIdx.y * BN;
  Acc<1> acc;
  if (bits == 4)
    tile_sums<Tin, 4, 1>(acc, smem, x, M, K, N, packed, scales, gs, n0, c0,
                         c1);
  else if (bits == 2)
    tile_sums<Tin, 2, 1>(acc, smem, x, M, K, N, packed, scales, gs, n0, c0,
                         c1);
  else
    tile_sums<Tin, 8, 1>(acc, smem, x, M, K, N, packed, scales, gs, n0, c0,
                         c1);
  // this thread's sums, in its fragment order, where the ring was
  float* mine = reinterpret_cast<float*>(smem) + threadIdx.x * NT * 4;
  __syncthreads();                           // every warp is off the ring
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) mine[4 * j + v] = acc[0][j][v];
  cluster.sync();                            // every rank's sums are out
  if (rank == 0) {
    for (int r = 1; r < (int)gridDim.z; ++r) {  // the cluster spans z
      const float* theirs = cluster.map_shared_rank(mine, r);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[0][j][v] += theirs[4 * j + v];
    }
    store_tile<1>(acc, M, N, out, out_bf16, n0);
  }
  cluster.sync();             // no rank leaves before rank 0 has read it
}

// K splits for `blocks` blocks of at most 16 rows: enough for one block an
// SM, at most 8 (a portable cluster), each split a whole number of chunks
// and scale groups. Returns the split count (1: no split) and sets cps,
// the chunks of a split.
static int choose_splits(int blocks, int K, int gs, int& cps) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int nchunks = (K + BK - 1) / BK;
  const int unit = BK / std::gcd(BK, gs) * gs / BK;  // lcm(BK, gs) / BK
  const int units = (nchunks + unit - 1) / unit;
  const int want = std::min(8, std::min(units, (sms + blocks - 1) / blocks));
  cps = nchunks;
  if (want <= 1) return 1;
  cps = (units + want - 1) / want * unit;
  return (nchunks + cps - 1) / cps;
}

template <typename Tin>
static int launch_split(const void* x, const void* packed,
                        const void* scales, void* out, int out_bf16, int M,
                        int K, int N, int bits, int gs, int splits, int cps,
                        cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, 1>();
  static_assert(smem >= THREADS * NT * 4 * 4, "sums exchange fits the ring");
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, (N + BN - 1) / BN, splits);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dense_split_kernel<Tin>, static_cast<const Tin*>(x),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      out, out_bf16, M, K, N, bits, gs, cps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace qm_mma

// Plain C entry point for ctypes. x_bf16 / out_bf16 select bf16 (1) or f32
// (0). Returns the CUDA error of the launch (0 on success); the Python
// wrapper raises on anything else.
extern "C" int qm_dense_launch(const void* x, int x_bf16, const void* packed,
                               const void* scales, void* out, int out_bf16,
                               int M, int K, int N, int bits, int gs,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one m16 tile a block for at most 16 rows (decode), split over K where
  // the column tiles alone leave SMs idle
  const bool small = M <= 16;
  if (small) {
    int cps = 0;
    const int splits = qm_mma::choose_splits((N + mmt::BN - 1) / mmt::BN, K,
                                             gs, cps);
    if (splits > 1)
      return x_bf16 ? qm_mma::launch_split<__nv_bfloat16>(
                          x, packed, scales, out, out_bf16, M, K, N, bits,
                          gs, splits, cps, s)
                    : qm_mma::launch_split<float>(x, packed, scales, out,
                                                  out_bf16, M, K, N, bits,
                                                  gs, splits, cps, s);
  }
  if (x_bf16)
    return small ? qm_mma::launch<__nv_bfloat16, 1>(x, packed, scales, out,
                                                    out_bf16, M, K, N, bits,
                                                    gs, s)
                 : qm_mma::launch<__nv_bfloat16, 4>(x, packed, scales, out,
                                                    out_bf16, M, K, N, bits,
                                                    gs, s);
  return small ? qm_mma::launch<float, 1>(x, packed, scales, out, out_bf16,
                                          M, K, N, bits, gs, s)
               : qm_mma::launch<float, 4>(x, packed, scales, out, out_bf16,
                                          M, K, N, bits, gs, s);
}

// Resources of instantiation `which`, in the order of
// INSTANTIATIONS["qm_dense"] in repro_torch/analysis/resources.py:
// out = {numRegs, localSizeBytes, sharedSizeBytes,
// maxDynamicSharedSizeBytes, requested dynamic shared memory}.
extern "C" int qm_dense_attrs(int which, int* out) {
  switch (which) {
    case 0: return mmt::func_attrs(qm_mma::dense_kernel<__nv_bfloat16, 1>,
                                 mmt::smem_bytes<__nv_bfloat16, 1>(), out);
    case 1: return mmt::func_attrs(qm_mma::dense_kernel<__nv_bfloat16, 4>,
                                 mmt::smem_bytes<__nv_bfloat16, 4>(), out);
    case 2: return mmt::func_attrs(qm_mma::dense_kernel<float, 1>,
                                 mmt::smem_bytes<float, 1>(), out);
    case 3: return mmt::func_attrs(qm_mma::dense_kernel<float, 4>,
                                 mmt::smem_bytes<float, 4>(), out);
    case 4: return mmt::func_attrs(qm_mma::dense_split_kernel<__nv_bfloat16>,
                                 mmt::smem_bytes<__nv_bfloat16, 1>(), out);
    case 5: return mmt::func_attrs(qm_mma::dense_split_kernel<float>,
                                 mmt::smem_bytes<float, 1>(), out);
  }
  return (int)cudaErrorInvalidValue;
}
