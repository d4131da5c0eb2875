// K4: flash-attention forward with the per-query log-sum-exp, on the bf16
// tensor cores.
//
// Replaces the TPU kernel flash_fwd_pallas
// (src/repro/kernels/attn_scores/attn_scores.py, body _fwd_kernel). For
// q, k, v (H, S, D) and scale 1/sqrt(D):
//   out[h, i] = softmax_j(s_ij) v[h, j],   lse[h, i] = log sum_j exp(s_ij)
// with s_ij = scale q_i . k_j, and under `causal` s_ij = -1e30 for j > i
// (the reference's masked logit: weight exactly 0). A query that sees no
// key gets out 0 and lse -1e30.
//
// What bounds it on an H100: 4 H S^2 D operations (half of it under
// causal) against 4 H S D elements moved. At the bf16 tensor-core rate
// (989 TFLOP/s) that is bound by operations from S ~ 512 in f32 and by
// bytes below ~ 1000 in bf16; at S 4096, D 128, H 16 causal 6.87e10 FLOP,
// 0.069 ms. The tensor cores run more MMAs than that count to keep f32
// accuracy (score_tile.cuh):
//   QK^T  bf16: 1 MMA;  f32: 6 (three bf16 planes of q and of k).
//   P V   bf16: 2 (p as hi + lo planes, v as it is);
//         f32: 3 (p.hi v.hi, p.hi v.lo, p.lo v.hi; v in two planes).
// P is f32 in [0, 1]: one bf16 plane would move out by ~2e-3 on rows with
// few keys, beyond the 1e-4 (1 + |ref|) tolerance; two keep it at 2^-16.
//
// The design: one block of 4 warps per (64-query tile, head), 16 query
// rows a warp; a 1-D grid ordered heaviest first (under `causal` block b
// takes query tile nq - 1 - b / H of head b % H, so the short tiles fill
// the tail). The block loops over key tiles of CT rows (the TPU grid's
// sequential key axis):
//   - bf16: k and v land by cp.async in a 2-deep ring, one barrier a tile;
//   - f32: k and v land by cp.async in one f32 buffer while the tensor
//     cores work on the previous tile's planes; at the tile's turn the
//     block splits them into bf16 planes (k: 3, v: 2), two barriers a
//     tile. CT 32 at D > 64 so that two blocks fit an SM.
// A warp's q fragments stay in registers for bf16 up to D 128; f32 q is
// split into planes from shared memory at every tile (three planes would
// not fit beside o). S = Q K^T stays in MMA accumulators; the online
// softmax (row max and sum over a lane quad by shuffles, in the log2
// domain, exp2 on the SFU) runs in registers with no block barrier; the
// m16n8 accumulators of two adjacent key n8 tiles are, re-packed as bf16
// planes, the m16n8k16 A fragment of P V, so P never leaves registers. V
// is the B operand through ldmatrix.trans.
// Under `causal` the key tiles wholly above the block's diagonal are not
// loaded, a warp skips a tile wholly above its own rows (weight 0, and
// its max and sum stay), and only tiles that cross a warp's diagonal or
// the ragged end S are masked.
//
// Shared memory (D 128): bf16 85 KB (q 17 KB, ring 68 KB): two blocks an
// SM; f32 110.5 KB (q 36 KB, landing 32 KB, planes 42.5 KB): two blocks.
// D 256: bf16 165 KB, f32 214.5 KB (CT 32): one block.
#include "score_tile.cuh"

namespace attn {

template <typename T>
__host__ __device__ constexpr size_t fwd_smem_bytes(int ct, int dp) {
  return row_tile_bytes<T>(dp) +
         (sizeof(T) == 4 ? 2 * landing_bytes(ct, dp) + 5 * plane_bytes(ct, dp)
                         : 4 * plane_bytes(ct, dp));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, DMAX > 128 ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int S, int D, int causal,
                 float scale, int vec) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int CT = col_rows<T>(DMAX);   // keys of a tile
  constexpr int NB = CT / 8;              // n8 score tiles of a key tile
  constexpr int NO = DMAX / 8;            // n8 output tiles, at most
  constexpr int KMAX = DMAX / 16;         // k16 steps of q . k, at most
  // bf16 q fragments stay in registers up to D 128 (32 registers); f32
  // ones (three planes) do not fit beside o, so each tile reloads them
  constexpr bool QREG = !F32 && DMAX <= 128;
  extern __shared__ __align__(16) uint8_t smem[];
  const int dp = pad16(D), lda = ld_rows<T>(dp), ldb = ld_bf16(dp);
  const int pst = CT * ldb;               // elements of a tile or a plane
  T* sq = reinterpret_cast<T*>(smem);
  uint8_t* rest = smem + row_tile_bytes<T>(dp);
  // f32: the landing buffer (k rows, then v rows); then the bf16 tiles:
  // f32 k hi, mid, lo, v hi, lo; bf16 the ring, stage s = k, v at 2 s pst
  float* land = reinterpret_cast<float*>(rest);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
      F32 ? rest + 2 * landing_bytes(CT, dp) : rest);

  const int h = blockIdx.x % H;
  const int nq = gridDim.x / H;
  const int qt = causal ? nq - 1 - blockIdx.x / H : blockIdx.x / H;
  const int q0 = ROWS * qt;
  const size_t head = (size_t)h * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 16 * warp;        // the warp's first query

  if (D < dp) {                           // depth padding of copied tiles
    zero_cols<ROWS>(sq, lda, D, dp);
    if constexpr (F32)
      zero_cols<2 * CT>(land, dp, D, dp);
    else
      zero_cols<4 * CT>(tiles, ldb, D, dp);
  }
  copy_rows<ROWS>(sq, lda, q + head, q0, S, D, vec);
  const int k_end = causal ? min(S, q0 + ROWS) : S;
  const int nk = (k_end + CT - 1) / CT;
  auto issue = [&](int kt) {
    const int k0 = kt * CT;
    if constexpr (F32) {
      copy_rows<CT>(land, dp, k + head, k0, S, D, vec);
      copy_rows<CT>(land + CT * dp, dp, v + head, k0, S, D, vec);
    } else {
      __nv_bfloat16* st = tiles + (kt & 1) * 2 * pst;
      copy_rows<CT>(st, ldb, k + head, k0, S, D, vec);
      copy_rows<CT>(st + pst, ldb, v + head, k0, S, D, vec);
    }
    cp_async_commit();
  };
  issue(0);                               // one group with q

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8 of the warp: running max (log2 domain) and this
  // lane's part of the running sum (the quad adds its parts at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;
  const int ksteps = dp / 16;
  uint32_t qf[QREG ? KMAX : 1][planes<T>()][4];

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();          // tile kt has landed; tile kt - 1 is read
    if constexpr (F32) {
      split_rows<3, CT>(tiles, pst, land, dp);
      split_rows<2, CT>(tiles + 3 * pst, pst, land + CT * dp, dp);
      __syncthreads();        // planes ready, landing buffer free
    }
    if constexpr (QREG)
      if (kt == 0) load_rows_a<T, KMAX>(qf, sq, lda, ksteps);
    if (kt + 1 < nk) issue(kt + 1);
    const __nv_bfloat16* kb = F32 ? tiles : tiles + (kt & 1) * 2 * pst;
    const __nv_bfloat16* vb = kb + (F32 ? 3 : 1) * pst;
    const int k0 = kt * CT;
    if (causal && k0 > r_lo + 15) continue;   // above every row of the warp

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (QREG)
      score_tile<1, NB, KMAX>(s, qf, kb, ldb, pst, ksteps);
    else
      score_tile<T, NB, KMAX>(s, sq, lda, kb, ldb, pst, ksteps);

    // online softmax step, rows g (e 0, 1) and g + 8 (e 2, 3)
    const bool edge = k0 + CT > S || (causal && k0 + CT - 1 > r_lo);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r_lo + g + 8 * (e >> 1);
          if (key >= S || (causal && key > row)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;     // no key seen yet
      alpha[i] = exp2_fast(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_fast(s[j][e] - mu[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += P V, k16 step kk = key n8 tiles 2 kk and 2 kk + 1
    const __nv_bfloat16* vrow = vb + (lane & 15) * ldb + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const __nv_bfloat16* vk = vrow + 16 * kk * ldb;
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        if (16 * jp >= dp) break;                // block-uniform
        uint32_t vh[4];
        ldmatrix_x4_trans(vh, vk + 16 * jp);
        mma_bf16(o[2 * jp], pl, vh[0], vh[1]);
        mma_bf16(o[2 * jp + 1], pl, vh[2], vh[3]);
        if constexpr (F32) {
          uint32_t vl[4];
          ldmatrix_x4_trans(vl, vk + pst + 16 * jp);
          mma_bf16(o[2 * jp], ph, vl[0], vl[1]);
          mma_bf16(o[2 * jp + 1], ph, vl[2], vl[3]);
        }
        mma_bf16(o[2 * jp], ph, vh[0], vh[1]);
        mma_bf16(o[2 * jp + 1], ph, vh[2], vh[3]);
      }
    }
  }

  // the quad's parts of each row sum, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + g + 8 * i;
    if (row >= S) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    float* dst = out + head + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = 8 * j + 2 * t;
      if (c >= D) break;
      const float v0 = o[j][2 * i] / safe, v1 = o[j][2 * i + 1] / safe;
      if (pairs) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
      } else {
        dst[c] = v0;
        if (c + 1 < D) dst[c + 1] = v1;
      }
    }
    if (t == 0)
      lse[(size_t)h * S + row] =
          l[i] == 0.f ? NEG : (m[i] + log2f(l[i])) * LN2;
  }
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const void* v, float* out,
                  float* lse, int H, int S, int D, int causal, float scale,
                  cudaStream_t stream) {
  constexpr int CT = col_rows<T>(DMAX);
  // once, for the most shared memory any D of this instantiation takes
  static const cudaError_t attr =
      allow_smem(flash_fwd_kernel<T, DMAX>, fwd_smem_bytes<T>(CT, DMAX));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = fwd_smem_bytes<T>(CT, pad16(D));
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                  (D * sizeof(T)) % 16 == 0;
  const unsigned blocks = (unsigned)H * ((S + ROWS - 1) / ROWS);
  flash_fwd_kernel<T, DMAX><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, lse, H, S, D, causal, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, float* out,
                    float* lse, int H, int S, int D, int causal, float scale,
                    cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, H, S, D, causal, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, H, S, D, causal, scale, stream);
  return launch<T, MAX_D>(q, k, v, out, lse, H, S, D, causal, scale, stream);
}

}  // namespace attn

// Plain C entry point for ctypes. in_bf16 selects bf16 (1) or f32 (0)
// q/k/v; out and lse are f32. Needs 1 <= D <= 256 (the wrapper checks).
// Returns the first CUDA error of the launch (0 on success); the Python
// wrapper raises on anything else.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                int in_bf16, void* out, void* lse, int H,
                                int S, int D, int causal, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  if (in_bf16)
    return attn::launch_d<__nv_bfloat16>(q, k, v, o, l, H, S, D, causal,
                                         scale, s);
  return attn::launch_d<float>(q, k, v, o, l, H, S, D, causal, scale, s);
}
