// Tensor-core block routine of the packed-weight matmuls: exact bf16
// mma.sync on the integer codes, group scales applied to f32 partial sums,
// cp.async-staged codes, scales and live activation rows. Its users are
// the three packed matmul kernels: K1 (expert_quant_matmul_grouped.cu), K2
// (expert_quant_matmul.cu) and K3 (quant_matmul.cu); each is a kernel body
// that picks a store and a row tile and calls region_tile (K3's split over
// K: tile_sums on a K range, the sums added across a cluster, store_tile).
//
// One thread block owns one (16*MT-row tile, BN-column tile) of
//   y = x @ dequant(packed, scales)
// for one store (an expert's precision region, an expert's chosen
// precision, or a dense matrix), and walks K in BK-deep chunks through
// a STAGES-deep ring in shared memory (one barrier per chunk; the copies of
// chunk c + STAGES - 1 are in flight while the tensor cores work on chunk c).
//
// Layouts (as the JAX package stores them; nothing is repacked):
//   x       (rows, K)        f32 or bf16, K contiguous
//   packed  (N, K / vpb)     uint8, offset-coded codes packed along K:
//                            value j of a byte sits at bit bits*j and
//                            decodes as ((byte >> bits*j) & mask) - 2^(bits-1)
//   scales  (K / gs, N)      f32, N contiguous
//   out     (rows, N)        f32 or bf16
//
// Exactness. Operand B of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 is
// the integer code q - 2^(bits-1), |q| <= 128, exact in bf16. Operand A is
// x: bf16 x as it is; f32 x split into three bf16 planes hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x exactly while
// the lo plane stays normal (|x| >= 2^-110), each plane run through its own
// MMA into the same accumulator. Below that the lo plane rounds to bf16's
// subnormal grid (2^-133), and an f32 subnormal x to the same grid: an
// absolute error of at most 2^-134 per element. Every product is exact.
// The sums are not the reference's (which widens x to f32 and dots in f32):
// they run in another order, and inside each MMA the f32 accumulation
// follows the tensor core's own rounding, not IEEE round-to-nearest
// additions. The 5e-4 * (1 + |ref|) check against the plain version and
// equal greedy tokens against the CPU are what hold the result. No TF32
// anywhere.
//
// Scales. group_size % 16 == 0, so every k16 step lies inside one scale
// group: a group's steps accumulate into a partial sum `part`, and at the
// group's last step acc += scale[g, n] * part in f32 registers. No
// dequantized weight tile is ever built.
//
// Fragments. Inside one k16 MMA step the order of k is free as long as A
// and B use the same permutation. Logical k slots {2t, 2t+1, 2t+8, 2t+9}
// of lane group t (lane % 4) are mapped to physical k {4t .. 4t+3}: a lane's
// B fragment is four consecutive codes of its column (one 16-bit piece at 4
// bits, one byte at 2 bits, one word at 8 bits), unpacked straight into two
// bf16x2 registers, and its A fragment is four consecutive x values of each
// of its two rows (one 8-byte or 16-byte shared load per row).
//
// Warps split the columns only (warp w owns columns [WN w, WN (w + 1)) of
// the tile and all its rows), so each code of the tile is unpacked once per
// block. Rows at or past the region's live-row watermark are never copied
// and their A fragments are zeros in registers. The caller writes dead
// rows as zeros; a tile wholly past the watermark does no more than that.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmt {

// MT (a template argument): m16 tiles of a block, 16 * MT rows. 1 for
// decode regions (few live rows, less register and shared-memory room per
// block, so more blocks and more bytes in flight per SM), 4 for waves.
constexpr int BN = 128;             // columns of a block tile
constexpr int BK = 64;              // K depth of one staged chunk
constexpr int STAGES = 2;           // 3 and 4 measured slower on the H100
constexpr int THREADS = 128;        // 4 warps, 32 columns each
constexpr int WN = BN / (THREADS / 32);  // columns per warp
constexpr int NT = WN / 8;          // n8 tiles per warp
constexpr int XPAD = 16;            // x row padding (elements): no bank
                                    // conflicts on the A fragment loads
constexpr int MAX_GROUPS = BK / 16; // scale groups one chunk can touch

// Bytes per column of a staged code chunk: the packed chunk (BK * bits / 8
// bytes) padded to an odd number of 16-byte units, so the 8 columns a warp
// reads in one B load fall in distinct banks.
__host__ __device__ constexpr int code_stride(int bits) {
  return (BK * bits / 8 / 16) % 2 ? BK * bits / 8 : BK * bits / 8 + 16;
}

constexpr int CODE_STRIDE_MAX = code_stride(8);

template <typename Tin, int MT>
__host__ __device__ constexpr int x_tile_bytes() {
  return 16 * MT * (BK + XPAD) * (int)sizeof(Tin);
}

template <typename Tin, int MT>
__host__ __device__ constexpr int stage_bytes() {
  return x_tile_bytes<Tin, MT>() + BN * CODE_STRIDE_MAX + MAX_GROUPS * BN * 4;
}

template <typename Tin, int MT>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<Tin, MT>();
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes 0 writes zeros and reads nothing.
// A chunk reads only 16-64 bytes of each code column and 128-256 bytes of
// each x row, rows 1-4 KiB apart: the L2 is asked to fetch 256 bytes
// around each, so later chunks hit L2 and device memory sees 256-byte
// reads instead of scattered 32-byte sectors.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A (16x16, row) * B (16x8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ B fragments

// Four consecutive codes c0..c3 of one column -> b0 = (q0, q1),
// b1 = (q2, q3) in bf16, q = c - 2^(BITS-1). For 2 and 4 bits a code is
// OR-ed into the mantissa of bf16 128.0 (0x4300: 128 + c, exact for
// c < 128) and 128 + 2^(BITS-1) is subtracted, exactly. 8-bit codes do not
// fit bf16's 7-bit mantissa that way and go through f32.
template <int BITS>
__device__ __forceinline__ void unpack_b(const uint8_t* col, int s, int t,
                                         uint32_t& b0, uint32_t& b1) {
  if constexpr (BITS == 4) {
    const uint32_t p = *reinterpret_cast<const uint16_t*>(col + 8 * s + 2 * t);
    const uint32_t u0 = (p & 0xFu) | ((p << 12) & 0xF0000u) | 0x43004300u;
    const uint32_t u1 = ((p >> 8) & 0xFu) | ((p << 4) & 0xF0000u) |
                        0x43004300u;
    const __nv_bfloat162 off = __float2bfloat162_rn(136.f);
    b0 = bf162_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u0),
                            off));
    b1 = bf162_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u1),
                            off));
  } else if constexpr (BITS == 2) {
    const uint32_t p = col[4 * s + t];
    const uint32_t u0 = (p & 0x3u) | ((p << 14) & 0x30000u) | 0x43004300u;
    const uint32_t u1 = ((p >> 4) & 0x3u) | ((p << 10) & 0x30000u) |
                        0x43004300u;
    const __nv_bfloat162 off = __float2bfloat162_rn(130.f);
    b0 = bf162_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u0),
                            off));
    b1 = bf162_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u1),
                            off));
  } else {
    const uint32_t p = *reinterpret_cast<const uint32_t*>(col + 16 * s + 4 * t);
    // 2^23 + c as f32, minus 2^23 + 128: c - 128 exactly
    auto q = [p](int j) {
      return __uint_as_float(0x4B000000u | ((p >> (8 * j)) & 0xFFu)) -
             8388736.f;
    };
    b0 = bf162_bits(__floats2bfloat162_rn(q(0), q(1)));
    b1 = bf162_bits(__floats2bfloat162_rn(q(2), q(3)));
  }
}

// ------------------------------------------------------------ A fragments

// bf16 x: one A fragment, rows r and r + 8 of the staged tile, physical k
// [16s + 4t, 16s + 4t + 4): {a0, a2} of row r, {a1, a3} of row r + 8.
__device__ __forceinline__ void load_a(const __nv_bfloat16* xs, int r,
                                       bool live0, bool live1, int s, int t,
                                       uint32_t (*a)[4]) {
  const int stride = BK + XPAD;
  uint2 v0 = make_uint2(0u, 0u), v1 = make_uint2(0u, 0u);
  if (live0)
    v0 = *reinterpret_cast<const uint2*>(xs + r * stride + 16 * s + 4 * t);
  if (live1)
    v1 = *reinterpret_cast<const uint2*>(xs + (r + 8) * stride + 16 * s +
                                         4 * t);
  a[0][0] = v0.x;
  a[0][1] = v1.x;
  a[0][2] = v0.y;
  a[0][3] = v1.y;
}

// f32 v = hi + mid + lo, each bf16 (exact while lo is normal, see above)
__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  __nv_bfloat16 h0, m0, l0, h1, m1, l1;
  split3(v0, h0, m0, l0);
  split3(v1, h1, m1, l1);
  hi = bf162_bits(__halves2bfloat162(h0, h1));
  mid = bf162_bits(__halves2bfloat162(m0, m1));
  lo = bf162_bits(__halves2bfloat162(l0, l1));
}

// f32 x: the three planes' A fragments a[0] (hi), a[1] (mid), a[2] (lo)
__device__ __forceinline__ void load_a(const float* xs, int r, bool live0,
                                       bool live1, int s, int t,
                                       uint32_t (*a)[4]) {
  const int stride = BK + XPAD;
  float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
  if (live0)
    v0 = *reinterpret_cast<const float4*>(xs + r * stride + 16 * s + 4 * t);
  if (live1)
    v1 = *reinterpret_cast<const float4*>(xs + (r + 8) * stride + 16 * s +
                                          4 * t);
  split_pair(v0.x, v0.y, a[0][0], a[1][0], a[2][0]);
  split_pair(v1.x, v1.y, a[0][1], a[1][1], a[2][1]);
  split_pair(v0.z, v0.w, a[0][2], a[1][2], a[2][2]);
  split_pair(v1.z, v1.w, a[0][3], a[1][3], a[2][3]);
}

template <typename Tin>
__host__ __device__ constexpr int planes() {
  return sizeof(Tin) == 4 ? 3 : 1;
}

// ------------------------------------------------------------ staging

// Issue the copies of chunk [k0, k0 + kc) into one stage: the live rows of
// x, the codes of the tile's BN columns (zeros past N) and the scales of
// the groups the chunk touches. 16-byte cp.async where the addresses allow
// it (x16, codes16: block-uniform), else 4-byte cp.async for the codes and
// plain loads for x (stored synchronously; read only after a later
// barrier, like the asynchronous copies). Both loops walk a full BK chunk
// in 16-byte pieces and skip those past a short last one: their divisors
// stay compile-time constants (runtime divisors cost the wave a quarter of
// its time on the H100).
template <typename Tin, int BITS, int MT>
__device__ __forceinline__ void load_stage(uint8_t* stage, const Tin* x,
                                           int live_rows, int K, int N,
                                           const uint8_t* packed,
                                           const float* scales, int gs,
                                           int n0, int k0, int kc, bool x16,
                                           bool codes16) {
  constexpr int CS = code_stride(BITS);
  constexpr int EPC = 16 / (int)sizeof(Tin);     // x elements per piece
  constexpr int XPR = BK / EPC;                  // pieces of an x row
  constexpr int CPC = BK * BITS / 8 / 16;        // pieces of a code column
  Tin* xs = reinterpret_cast<Tin*>(stage);
  uint8_t* cs = stage + x_tile_bytes<Tin, MT>();
  float* ss = reinterpret_cast<float*>(cs + BN * CODE_STRIDE_MAX);
  const int tid = threadIdx.x;
  for (unsigned i = tid; i < live_rows * XPR; i += THREADS) {
    const unsigned r = i / XPR, c = i % XPR;
    if (c * EPC >= kc) continue;
    Tin* to = xs + r * (BK + XPAD) + c * EPC;
    const Tin* from = x + (size_t)r * K + k0 + c * EPC;
    if (x16) {
      cp_async16(to, from, 16);
    } else {
#pragma unroll
      for (int j = 0; j < EPC; ++j) to[j] = from[j];
    }
  }
  const size_t row_bytes = (size_t)K * BITS / 8;
  const uint8_t* src = packed + (size_t)k0 * BITS / 8;
  const int cb = kc * BITS / 8;                  // code bytes of a column
#pragma unroll
  for (unsigned i = tid; i < BN * CPC; i += THREADS) {
    const unsigned col = i / CPC, c = i % CPC;
    const int n = n0 + col;
    const bool ok = n < N;
    uint8_t* to = cs + col * CS + c * 16;
    const uint8_t* from = src + (size_t)(ok ? n : 0) * row_bytes + c * 16;
    if (codes16) {                               // cb % 16 == 0
      if (c * 16 < cb) cp_async16(to, from, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int w = 0; w < 16; w += 4)
        if (c * 16 + w < cb) cp_async4(to + w, from + w, ok ? 4 : 0);
    }
  }
  const int g0 = k0 / gs;
  const int ng = (k0 + kc - 1) / gs - g0 + 1;
  for (unsigned i = tid; i < ng * BN; i += THREADS) {
    const unsigned gi = i / BN, col = i % BN;
    const int n = n0 + col;
    const bool ok = n < N;
    cp_async4(ss + gi * BN + col, scales + (size_t)(g0 + gi) * N + (ok ? n : 0),
              ok ? 4 : 0);
  }
}

__device__ __forceinline__ void store2(void* out, bool out_bf16, size_t i,
                                       float v0, float v1, bool pair,
                                       bool has1) {
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (has1) o[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + i;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (has1) o[1] = v1;
    }
  }
}

// ------------------------------------------------------------ block tile

// The block's sums live in registers in mma.sync's accumulator layout:
// acc[mi][j][v] is element v of this lane's fragment of m16 tile mi and n8
// tile j of its warp's columns.
template <int MT>
using Acc = float[MT][NT][4];

// acc = sum over the K chunks [c_begin, c_end) (c_begin * BK a multiple of
// gs, so no scale group straddles two ranges; c_end * BK >= K or a group
// boundary) of x[r, k] * dequant(packed, scales)[k, n], for the rows
// r < live_rows (1 <= live_rows <= 16 * MT) and the columns [n0, n0 + BN)
// ∩ [0, N) of the block's tile; the sums of rows past live_rows are 0. x,
// packed and scales point at the tile's first row / its store, K is their
// full depth. smem holds smem_bytes<Tin, MT>(); other warps may still
// read it on return (a barrier comes before any other use).
template <typename Tin, int BITS, int MT>
__device__ __forceinline__ void tile_sums(
    Acc<MT>& acc, uint8_t* smem, const Tin* __restrict__ x, int live_rows,
    int K, int N, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, int gs, int n0, int c_begin,
    int c_end) {
  constexpr int CS = code_stride(BITS);
  constexpr int PL = planes<Tin>();
  constexpr int SB = stage_bytes<Tin, MT>();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int gsteps = gs / 16;                    // k16 steps per group
  const bool x16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool codes_aligned =
      (reinterpret_cast<uintptr_t>(packed) & 15) == 0 &&
      ((size_t)K * BITS / 8) % 16 == 0;

  float part[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][j][v] = part[mi][j][v] = 0.f;

  auto issue = [&](int c) {
    if (c < c_end) {
      const int k0 = c * BK, kc = min(BK, K - k0);
      load_stage<Tin, BITS, MT>(smem + (c % STAGES) * SB, x, live_rows, K, N,
                            packed, scales, gs, n0, k0, kc, x16,
                            codes_aligned && (kc * BITS / 8) % 16 == 0);
    }
    cp_async_commit();                           // empty groups keep count
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c_begin + c);

  int gpos = 0;                  // k16 steps of the current scale group done
  int gidx = c_begin * BK / gs;  // current scale group
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait<STAGES - 2>();                 // chunk c has landed
    __syncthreads();     // ... for every thread; chunk c-1's stage is free
    issue(c + STAGES - 1);
    const uint8_t* stage = smem + (c % STAGES) * SB;
    const Tin* xs = reinterpret_cast<const Tin*>(stage);
    const uint8_t* cs = stage + x_tile_bytes<Tin, MT>();
    const float* ss =
        reinterpret_cast<const float*>(cs + BN * CODE_STRIDE_MAX);
    const int k0 = c * BK, kc = min(BK, K - k0);
    const int g0 = k0 / gs;
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      if (16 * s >= kc) break;                   // block-uniform
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        unpack_b<BITS>(cs + (warp * WN + 8 * j + g) * CS, s, t, b[j][0],
                       b[j][1]);
      // Every m16 tile issues its MMAs, dead rows' A being zeros: a branch
      // per tile would keep the A loads from being hoisted above the MMAs
      // of the tile before (the last tile of a region wastes < 3 tiles).
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = 16 * mi + g;
        uint32_t a[PL][4];
        load_a(xs, r, r < live_rows, r + 8 < live_rows, s, t, a);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int pl = PL - 1; pl >= 0; --pl)    // lo, mid, hi
            mma_bf16(part[mi][j], a[pl], b[j][0], b[j][1]);
      }
      if (++gpos == gsteps) {                    // the group ends here
        const float* sg = ss + (gidx - g0) * BN + warp * WN + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(sg + 8 * j);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            acc[mi][j][0] = fmaf(sc.x, part[mi][j][0], acc[mi][j][0]);
            acc[mi][j][1] = fmaf(sc.y, part[mi][j][1], acc[mi][j][1]);
            acc[mi][j][2] = fmaf(sc.x, part[mi][j][2], acc[mi][j][2]);
            acc[mi][j][3] = fmaf(sc.y, part[mi][j][3], acc[mi][j][3]);
#pragma unroll
            for (int v = 0; v < 4; ++v) part[mi][j][v] = 0.f;
          }
        }
        gpos = 0;
        ++gidx;
      }
    }
  }
  cp_async_wait<0>();
}

// out[r, n] = acc for the rows r < live_rows and the columns [n0, n0 + BN)
// ∩ [0, N) of the block's tile; out points at the tile's first row.
template <int MT>
__device__ __forceinline__ void store_tile(const Acc<MT>& acc,
                                           int live_rows, int N, void* out,
                                           bool out_bf16, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool pair_ok = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + warp * WN + 8 * j + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mi + g + 8 * h;
        if (r < live_rows)
          store2(out, out_bf16, (size_t)r * N + n, acc[mi][j][2 * h],
                 acc[mi][j][2 * h + 1], pair_ok, n + 1 < N);
      }
    }
  }
}

// out[r, n] = sum_k x[r, k] * dequant(packed, scales)[k, n] over all of K,
// for the rows r < live_rows (1 <= live_rows <= 16 * MT) and the columns
// [n0, n0 + BN) ∩ [0, N) of the block's tile. x, packed, scales and out
// point at the tile's first row / its expert's store. smem holds
// smem_bytes<Tin, MT>(). Rows past live_rows are neither read nor written
// here.
template <typename Tin, int BITS, int MT>
__device__ __forceinline__ void region_tile(
    uint8_t* smem, const Tin* __restrict__ x, int live_rows, int K, int N,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    int gs, void* out, bool out_bf16, int n0) {
  Acc<MT> acc;
  tile_sums<Tin, BITS, MT>(acc, smem, x, live_rows, K, N, packed, scales,
                           gs, n0, 0, (K + BK - 1) / BK);
  store_tile<MT>(acc, live_rows, N, out, out_bf16, n0);
}

// ------------------------------------------------------------ kernel helpers

// out + elems elements, in the output's element type
__device__ __forceinline__ void* out_at(void* out, bool out_bf16,
                                        size_t elems) {
  return out_bf16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(out) +
                                       elems)
                  : static_cast<void*>(static_cast<float*>(out) + elems);
}

// Rows [row0, row0 + rows) x columns [n0, n0 + BN) ∩ [0, N) of out (row
// pitch N) as exact zeros: the dead or skipped rows of a tile (the output
// comes from torch.empty).
__device__ __forceinline__ void zero_rows(void* out, bool out_bf16,
                                          size_t row0, int rows, int N,
                                          int n0) {
  const int ncols = min(BN, N - n0);
  for (int i = threadIdx.x; i < rows * ncols; i += THREADS) {
    const size_t o = (row0 + i / ncols) * N + n0 + i % ncols;
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(0.f);
    else
      static_cast<float*>(out)[o] = 0.f;
  }
}

// region_tile at a store's bit width (2, 4 or 8; block-uniform)
template <typename Tin, int MT>
__device__ __forceinline__ void region_tile_bits(
    int bits, uint8_t* smem, const Tin* x, int live_rows, int K, int N,
    const uint8_t* packed, const float* scales, int gs, void* out,
    bool out_bf16, int n0) {
  if (bits == 4)
    region_tile<Tin, 4, MT>(smem, x, live_rows, K, N, packed, scales, gs,
                            out, out_bf16, n0);
  else if (bits == 2)
    region_tile<Tin, 2, MT>(smem, x, live_rows, K, N, packed, scales, gs,
                            out, out_bf16, n0);
  else
    region_tile<Tin, 8, MT>(smem, x, live_rows, K, N, packed, scales, gs,
                            out, out_bf16, n0);
}

// One row tile of a grid of 16*MT-row tiles, all `rows` of it live: the
// one-m16 routine where the tile holds at most 16 rows (the ragged last
// tile of M = 80 is 16 rows: MMAs for 16 rows, not 64), else region_tile
// at MT. K2 and K3, whose rows are all live, take their tiles through it.
template <typename Tin, int MT>
__device__ __forceinline__ void row_tile(int bits, uint8_t* smem,
                                         const Tin* x, int rows, int K,
                                         int N, const uint8_t* packed,
                                         const float* scales, int gs,
                                         void* out, bool out_bf16, int n0) {
  if constexpr (MT > 1) {
    if (rows <= 16) {
      region_tile_bits<Tin, 1>(bits, smem, x, rows, K, N, packed, scales,
                               gs, out, out_bf16, n0);
      return;
    }
  }
  region_tile_bits<Tin, MT>(bits, smem, x, rows, K, N, packed, scales, gs,
                            out, out_bf16, n0);
}

// cudaFuncGetAttributes of `kernel` into out = {numRegs, localSizeBytes,
// sharedSizeBytes, maxDynamicSharedSizeBytes, requested}, where
// `requested` is the dynamic shared memory its launcher asks for: the
// <lib>_attrs entry points (repro_torch/analysis/resources.py). Returns
// the CUDA error (0 on success).
template <typename K>
inline int func_attrs(K* kernel, int requested, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = requested;
  return 0;
}

}  // namespace mmt
