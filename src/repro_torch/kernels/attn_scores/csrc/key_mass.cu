// K5: per-key received attention mass, DyMoE Eq. 1, on the bf16 tensor
// cores.
//
// Replaces the TPU kernel key_mass_pallas
// (src/repro/kernels/attn_scores/attn_scores.py, body _mass_kernel). For
// q, k (H, S, D), the per-query lse (H, S) of K4 and scale 1/sqrt(D):
//   mass[h, j] = sum_i exp(s_ij - lse[h, i])
// with s_ij = scale q_i . k_j, and under `causal` s_ij = -1e30 for j > i.
// With the lse known every normalised probability is recomputable on its
// own, so the S x S matrix never exists.
//
// What bounds it on an H100: 2 H S^2 D operations (half of it under
// causal) and H S^2 exponentials against 2 H S D elements read: at the
// bf16 tensor-core rate, operations (S 4096, D 128, H 16 causal: 3.4e10
// FLOP, 0.035 ms; its 1.3e8 exponentials take about as long on the SFUs).
// The scores are K4's (score_tile.cuh): bf16 1 MMA, f32 6 over three
// bf16 planes of k and of q, so exp(s - lse) agrees with K4's lse.
//
// The design: one block of 4 warps per (64-key tile, head), 16 keys a
// warp, in a 1-D grid ordered heaviest first (block b takes key tile
// b / H of head b % H; under `causal` key tile 0 sees every query). The
// key tile stays resident and is the MMA's A operand: S^T = K Q^T, keys
// as the M rows and the queries of a streamed tile of CT rows (with their
// lse) as the N columns; K and Q are both (S, D) with D contiguous,
// exactly .row.col's A and B. Each warp's key fragments (f32: three
// planes) are loaded once and stay in registers (f32 at D 256: reloaded
// from shared memory every tile). The block loops over the query tiles on
// or below its diagonal (all of them without `causal`), the TPU grid's
// sequential query axis:
//   - bf16: q and lse land by cp.async in a 2-deep ring;
//   - f32: q lands in an f32 buffer and the block splits it into three
//     bf16 planes at its turn (two barriers a tile); CT 32 at D > 64.
// Each key's mass is a row sum of the accumulator fragment: a lane adds
// exp2 of its columns in registers over all query tiles, and at the end
// the quad adds its four parts by shuffles in a fixed order and one lane
// stores. The block owns its keys: no atomics, no workspace, the same
// result on every run. A warp skips a query tile wholly before its keys;
// only tiles that cross its diagonal or the ragged end S are masked.
//
// Shared memory (D 128): bf16 51.5 KB (k 17 KB, ring 34 KB); f32 78 KB
// (k 36 KB, landing 16 KB, planes 25.5 KB). D 256 f32: 150 KB.
#include "score_tile.cuh"

namespace attn {

template <typename T>
__host__ __device__ constexpr size_t mass_smem_bytes(int ct, int dp) {
  return row_tile_bytes<T>(dp) + 2 * ct * 4 +
         (sizeof(T) == 4 ? landing_bytes(ct, dp) + 3 * plane_bytes(ct, dp)
                         : 2 * plane_bytes(ct, dp));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, 2)
key_mass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const float* __restrict__ lse, float* __restrict__ mass,
                int H, int S, int D, int causal, float scale, int vec) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int CT = col_rows<T>(DMAX);   // queries of a tile
  constexpr int NB = CT / 8;              // n8 score tiles of a query tile
  constexpr int KMAX = DMAX / 16;         // k16 steps of k . q, at most
  // the key tile's A fragments stay in registers (bf16: up to 64, f32
  // planes: up to 96 at D 128); f32 at D 256 reloads them every tile
  constexpr bool KREG = !F32 || DMAX <= 128;
  extern __shared__ __align__(16) uint8_t smem[];
  const int dp = pad16(D), lda = ld_rows<T>(dp), ldb = ld_bf16(dp);
  const int pst = CT * ldb;               // elements of a tile or a plane
  T* sk = reinterpret_cast<T*>(smem);
  float* sl = reinterpret_cast<float*>(smem + row_tile_bytes<T>(dp));
  uint8_t* rest = reinterpret_cast<uint8_t*>(sl + 2 * CT);  // lse ring
  // f32: the landing buffer, then q hi, mid, lo; bf16: the ring of q
  float* land = reinterpret_cast<float*>(rest);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
      F32 ? rest + landing_bytes(CT, dp) : rest);

  const int h = blockIdx.x % H;
  const int k0 = ROWS * (blockIdx.x / H);
  const size_t head = (size_t)h * S * D;
  const float* lse_h = lse + (size_t)h * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = k0 + 16 * warp;        // the warp's first key

  if (D < dp) {                           // depth padding of copied tiles
    zero_cols<ROWS>(sk, lda, D, dp);
    if constexpr (F32)
      zero_cols<CT>(land, dp, D, dp);
    else
      zero_cols<2 * CT>(tiles, ldb, D, dp);
  }
  copy_rows<ROWS>(sk, lda, k + head, k0, S, D, vec);
  // CT divides ROWS: the first query tile with a query at or below key k0
  const int qt0 = causal ? k0 / CT : 0;
  const int nqt = (S + CT - 1) / CT;
  auto issue = [&](int qt) {
    const int q0 = qt * CT;
    if constexpr (F32)
      copy_rows<CT>(land, dp, q + head, q0, S, D, vec);
    else
      copy_rows<CT>(tiles + (qt & 1) * pst, ldb, q + head, q0, S, D, vec);
    for (int i = threadIdx.x; i < CT; i += THREADS) {
      const bool ok = q0 + i < S;
      cp_async4(sl + (qt & 1) * CT + i, lse_h + (ok ? q0 + i : 0),
                ok ? 4 : 0);
    }
    cp_async_commit();
  };
  issue(qt0);                             // one group with k

  float ms[2] = {0.f, 0.f};               // keys g and g + 8 of the warp
  const float sl2 = scale * LOG2E;
  const int ksteps = dp / 16;
  uint32_t kf[KREG ? KMAX : 1][planes<T>()][4];

  for (int qt = qt0; qt < nqt; ++qt) {
    cp_async_wait<0>();
    __syncthreads();          // tile qt has landed; tile qt - 1 is read
    if constexpr (F32) {
      split_rows<3, CT>(tiles, pst, land, dp);
      __syncthreads();        // planes ready, landing buffer free
    }
    if constexpr (KREG)
      if (qt == qt0) load_rows_a<T, KMAX>(kf, sk, lda, ksteps);
    if (qt + 1 < nqt) issue(qt + 1);
    const __nv_bfloat16* qb = F32 ? tiles : tiles + (qt & 1) * pst;
    const float* lq = sl + (qt & 1) * CT;
    const int q0 = qt * CT;
    if (causal && q0 + CT - 1 < r_lo) continue;  // before every key of it

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (KREG)
      score_tile<planes<T>(), NB, KMAX>(s, kf, qb, ldb, pst, ksteps);
    else
      score_tile<T, NB, KMAX>(s, sk, lda, qb, ldb, pst, ksteps);

    // keys g (e 0, 1) and g + 8 (e 2, 3); queries 8j + 2t + (e & 1)
    const bool edge = q0 + CT > S || (causal && q0 < r_lo + 15);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(lq + 8 * j + 2 * t);
      const float lc[2] = {lv.x, lv.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[j][e], sl2, -lc[e & 1] * LOG2E);
        if (edge) {
          const int col = q0 + 8 * j + 2 * t + (e & 1);
          const int row = r_lo + g + 8 * (e >> 1);
          if (col >= S) continue;                // no such query
          if (causal && col < row) x = (NEG - lc[e & 1]) * LOG2E;
        }
        ms[e >> 1] += exp2_fast(x);
      }
    }
  }

  // the quad's parts of each key's mass, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ms[i] += __shfl_xor_sync(0xffffffffu, ms[i], 1);
    ms[i] += __shfl_xor_sync(0xffffffffu, ms[i], 2);
    const int row = r_lo + g + 8 * i;
    if (t == 0 && row < S) mass[(size_t)h * S + row] = ms[i];
  }
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const float* lse,
                  float* mass, int H, int S, int D, int causal, float scale,
                  cudaStream_t stream) {
  constexpr int CT = col_rows<T>(DMAX);
  // once, for the most shared memory any D of this instantiation takes
  static const cudaError_t attr =
      allow_smem(key_mass_kernel<T, DMAX>, mass_smem_bytes<T>(CT, DMAX));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = mass_smem_bytes<T>(CT, pad16(D));
  const int vec = aligned16(q) && aligned16(k) && (D * sizeof(T)) % 16 == 0;
  const unsigned blocks = (unsigned)H * ((S + ROWS - 1) / ROWS);
  key_mass_kernel<T, DMAX><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lse, mass, H, S,
      D, causal, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const float* lse,
                    float* mass, int H, int S, int D, int causal, float scale,
                    cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, lse, mass, H, S, D, causal, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, lse, mass, H, S, D, causal, scale, stream);
  return launch<T, MAX_D>(q, k, lse, mass, H, S, D, causal, scale, stream);
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
    return attn::launch_d<__nv_bfloat16>(q, k, l, m, H, S, D, causal, scale,
                                         s);
  return attn::launch_d<float>(q, k, l, m, H, S, D, causal, scale, s);
}
