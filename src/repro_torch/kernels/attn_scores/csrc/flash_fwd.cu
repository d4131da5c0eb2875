// K4: flash-attention forward with the per-query log-sum-exp.
//
// Replaces the TPU kernel flash_fwd_pallas
// (src/repro/kernels/attn_scores/attn_scores.py, body _fwd_kernel). For
// q, k, v (H, S, D) and scale 1/sqrt(D):
//   out[h, i] = softmax_j(s_ij) v[h, j],   lse[h, i] = log sum_j exp(s_ij)
// with s_ij = scale q_i . k_j, and under `causal` s_ij = -1e30 for j > i
// (the reference's masked logit). A query that sees no key gets out 0 and
// lse -1e30.
//
// What bounds it on an H100: 4 H S^2 D f32 operations (half of it under
// causal) against 4 H S D elements moved, some 20 operations per byte
// already at S 128: bound by f32 operations on the CUDA cores (true f32,
// as the reference; tensor cores would need TF32 or bf16 and another
// tolerance). The design: grid (ceil(S / 64), H), one block per (query
// tile, head); the loop over key tiles inside the block takes the place
// of the TPU grid's sequential key axis and its VMEM scratch. The running
// max m, sum l and the 64 x D output accumulator stay in registers; each
// key tile's scores go through shared memory once, where four threads per
// row take the online-softmax step. Under `causal` the key tiles wholly
// above the diagonal are skipped: once the first key tile has made m
// finite they would add exp(-1e30 - m) = 0 and rescale by exp(0) = 1.
// Keys and queries past S (a ragged last tile) are masked in the kernel.
#include "attn_tile.cuh"

namespace attn {

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int D, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sq = smem;                    // [BQ][ld]
  float* sk = sq + BQ * ld;            // [BK][ld]
  float* sv = sk + BK * ld;            // [BK][D]
  float* sp = sv + BK * D;             // [BQ][BK + 1] scores, then p
  float* s_alpha = sp + BQ * (BK + 1); // [BQ]
  float* s_l = s_alpha + BQ;           // [BQ]
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)h * S * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int sr = tid / 4, sc = (tid % 4) * 16;  // softmax: row, 16 columns
  constexpr int DJ = DMAX / 16;

  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  float m_i = NEG, l_i = 0.f;   // of row sr, replicated over its 4 threads

  load_rows(sq, ld, q + head, q0, S, D);
  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();           // the previous tile's sk, sv, sp are read
    load_rows(sk, ld, k + head, k0, S, D);
    load_rows(sv, D, v + head, k0, S, D);
    __syncthreads();
    float s[4][4];
    score_tile(sq, sk, ld, D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + ty + 16 * i, kj = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (kj >= S) val = -INFINITY;          // no such key: weight 0
        else if (causal && kj > qi) val = NEG;
        sp[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = val;
      }
    __syncthreads();
    // online softmax step of row sr, four threads per row
    float* row = sp + sr * (BK + 1) + sc;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float p = expf(row[c] - m_new);
      row[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    if ((tid & 3) == 0) s_alpha[sr] = alpha;
    __syncthreads();
    // o = alpha o + p v for the 4 rows x DJ columns this thread owns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= a;
    }
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? sv[c * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], vv, o[i][j]);
      }
    }
  }
  __syncthreads();
  if ((tid & 3) == 0) {
    s_alpha[sr] = m_i;
    s_l[sr] = l_i;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = s_l[r];
    const float safe = l == 0.f ? 1.f : l;
    float* dst = out + head + (size_t)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dst[d] = o[i][j] / safe;
    }
  }
  if (tid < BQ && q0 + tid < S) {
    const float l = s_l[tid];
    lse[(size_t)h * S + q0 + tid] = l == 0.f ? NEG : s_alpha[tid] + logf(l);
  }
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const void* v, float* out,
                  float* lse, int H, int S, int D, int causal, float scale,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (D + 1) +
                                       (size_t)BK * D + BQ * (BK + 1) +
                                       2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, 1);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, lse, S, D, causal, scale);
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
