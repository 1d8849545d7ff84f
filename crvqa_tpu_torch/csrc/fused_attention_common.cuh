// Device helpers shared by the short attention kernels
// (fused_attention_fwd.cu, fused_attention_bwd.cu) and the mid-length
// attention kernels (midseq_attention_fwd.cu, midseq_attention_bwd.cu,
// through midseq_mma_common.cuh). All include this file, so every kernel
// forms scores, exponentials and probabilities with the same arithmetic,
// the recompute backwards rebuild exactly the probabilities their forwards
// computed and stored, and all share one dropout hash.
//
// Two families of code:
//
// - the fp32 scalar kernels' row softmax over scores held in shared memory
//   (`row_max`, `row_exp_sum`, exact expf and one division per score);
// - the bf16 tensor-core kernels' building blocks: cp.async staging,
//   `ldmatrix` + `mma.sync.m16n8k16` (bf16 operands, fp32 accumulation),
//   `score` / `exp_sfu` / `prob`, and the short kernels' register-row
//   softmax statistics (`RowSoftmax`).
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane l is in group
// g = l / 4 and quad position c = l % 4. An fp32 accumulator tile [16 x 8]
// holds (row g, cols 2c, 2c + 1) in elements 0, 1 and (row g + 8, the same
// cols) in elements 2, 3. An A operand [16 x 16] holds, as bf16 pairs,
// (g, 2c..2c+1), (g + 8, 2c..2c+1), (g, 2c+8..2c+9), (g + 8, 2c+8..2c+9):
// two neighbouring accumulator tiles, rounded and packed, are one A
// operand, so probabilities never leave registers between two products.
//
// Every sum that must repeat bit for bit (row max, denominator, the quad
// exchange) uses __fadd_rn / __fmul_rn, which the compiler never contracts
// into an FMA: the same inputs give the same bits in every kernel that
// includes this file, and the four lanes of a quad end with equal values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fa {

constexpr int kHeadDim = 64;          // D
constexpr int kPitch = kHeadDim + 1;  // staged row pitch in floats
constexpr int kMaxHeadsTimesSeq = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp's maximum over a row of `sk` scores held in shared memory.
__device__ __forceinline__ float row_max(const float* row, int sk, int lane) {
  float m = -CUDART_INF_F;
  for (int j = lane; j < sk; j += 32) m = fmaxf(m, row[j]);
  return warp_max(m);
}

// One warp's softmax numerator over a row of `sk` scores held in shared
// memory: the row becomes exp(s - max) in place and the clamped denominator
// max(sum, 1e-30) is returned (crvqa_tpu/ops/fused_attention.py:203). Lane
// l owns entries l, l + 32, ...; the sums run in that order, so every caller
// of this function gets bit-identical probabilities for the same scores.
__device__ __forceinline__ float row_exp_sum(float* row, int sk, int lane) {
  const float m = row_max(row, sk, lane);
  float sum = 0.f;
  for (int j = lane; j < sk; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    sum += e;
  }
  return fmaxf(warp_sum(sum), 1e-30f);
}

// The dropout keep bit of `_keep_mask` (crvqa_tpu/ops/fused_attention.py:
// 62-83): a pure uint32 function of (seed, global batch row, head argument
// 0, row i, lane-blocked column j = h * Sk + k). `key` is
// seed * 2654435761 + b * 97531 (mod 2^32); keep iff hash >= threshold,
// threshold = min(int(rate * 2^32), 2^32 - 1).
__device__ __forceinline__ uint32_t keep_key(uint32_t seed, uint32_t b) {
  return seed * 2654435761u + b * 97531u;
}

// The same key with a head argument h (`_keep_mask(..., b, h)` adds
// h * 1000003): the mid-length kernel keys each head's plain [Sq, Sk] rows
// on its absolute head index (crvqa_tpu/ops/midseq_attention.py:125).
__device__ __forceinline__ uint32_t keep_key(uint32_t seed, uint32_t b,
                                             uint32_t h) {
  return keep_key(seed, b) + h * 1000003u;
}

// The key of global batch row `b` whose lane-blocked columns start at
// `col0` (= head0 * Sk: a rank holding heads head0.. of a tensor-parallel
// split): keep_bit(keep_key_at(seed, b, c0), i, j) ==
// keep_bit(keep_key(seed, b), i, j + c0), since the column enters the hash
// as j * 668265263 (mod 2^32). A data-parallel rank passes b + batch0, its
// first global row.
__device__ __forceinline__ uint32_t keep_key_at(uint32_t seed, uint32_t b,
                                                uint32_t col0) {
  return keep_key(seed, b) + col0 * 668265263u;
}

__device__ __forceinline__ bool keep_bit(uint32_t key, uint32_t i, uint32_t j,
                                         uint32_t threshold) {
  uint32_t x = i * 374761393u + j * 668265263u + key;
  x = x ^ (x >> 13);
  x = x * 1274126177u;
  x = x ^ (x >> 16);
  return x >= threshold;
}


// ============================================ bf16 tensor-core building blocks

using bf16 = __nv_bfloat16;

constexpr int kMmaPitch = kHeadDim + 8;  // staged bf16 row pitch: 144 bytes,
                                         // so the 8 rows of an ldmatrix hit
                                         // 32 different banks

// The probability residual p [B, Sq, H*Sk] as its element type P, a
// template parameter of the kernels that store or load it: fp32, or bf16
// (the P_RESIDUAL_DTYPE bf16 variant) rounded to nearest even, which the
// backward widens back to fp32 exactly. `*_p2` move two adjacent elements
// (8-byte fp32 or 4-byte bf16 pairs).
__device__ __forceinline__ void store_p(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_p(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_p2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_p2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ float load_p(const float* p) { return *p; }
__device__ __forceinline__ float load_p(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 load_p2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_p2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ------------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 8 bytes global -> shared; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// acc[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> one register of two bf16, round to nearest even; lo is the
// element of the smaller column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two accumulator tiles [16 x 8] (columns 0-7 and 8-15) -> one A operand
// [16 x 16] over those 16 columns, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc[n] (n = 0..7: a 16 x 64 output in 8 column tiles) += A [16 x 16] . B
// with B rows [r0, r0 + 16) of a staged [rows][kMmaPitch] tile (B's rows
// are the summed index), read through `ldmatrix.trans`.
__device__ __forceinline__ void mma_ab16(float (&acc)[8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b0, b1, b2, b3;
    const bf16* p = tile +
                    (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMmaPitch +
                    (np * 2 + (lane >> 4)) * 8;
    ldmatrix_x4_trans(b0, b1, b2, b3, p);
    mma_bf16(acc[2 * np], a, b0, b1);
    mma_bf16(acc[2 * np + 1], a, b2, b3);
  }
}

// Rows [r0, r0 + 16) of a staged [rows][kMmaPitch] tile as the A operands
// of four k-steps over D (a[kk] covers d in [16 kk, 16 kk + 16)).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile,
                                       int r0, int lane) {
  const bf16* p = tile + (r0 + (lane & 15)) * kMmaPitch + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk][0], a[kk][1], a[kk][2], a[kk][3], p + 16 * kk);
}

// 16-byte aligned pointer and row strides that keep every row 16-byte
// aligned: what cp.async and the 32-bit fragment loads need.
__host__ __forceinline__ bool aligned16(const void* p, int64_t s0,
                                        int64_t s1) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0;
}

// ---------------------------------------------------------------- staging

// Rows [r0, r0 + n) of one head's [S, D] slice (row stride `stride`
// elements, 16-byte aligned rows) -> tile[n][kMmaPitch], 16 bytes a thread
// with cp.async; rows at and past `rows` are zero-filled. The caller
// commits the group.
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* src,
                                           int64_t stride, int r0, int n,
                                           int rows, int tid, int nthreads) {
  for (int i = tid; i < n * (kHeadDim / 8); i += nthreads) {
    const int r = i >> 3, ch = i & 7;
    const bool live = r0 + r < rows;
    const bf16* from = src + (int64_t)(live ? r0 + r : 0) * stride + ch * 8;
    cp_async_16(tile + r * kMmaPitch + ch * 8, from, live ? 16 : 0);
  }
}

// A warp's 16 x 64 fp32 accumulator -> rows [r0, r0 + 16) of a bf16
// output with row stride `ld` (`out` points at the head's first column),
// rows < `rows` only, as 16-byte stores: the tile is rounded into the
// warp's own `slot` [16][kMmaPitch] of shared memory first.
__device__ __forceinline__ void store_tile(bf16* out, int64_t ld, int r0,
                                           int rows, const float (&acc)[8][4],
                                           bf16* slot, int lane) {
  const int g = lane >> 2, c = lane & 3;
  __syncwarp();  // the slot's last reads are done
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(slot + g * kMmaPitch + n * 8 + 2 * c) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(slot + (g + 8) * kMmaPitch + n * 8 + 2 * c) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = lane + 32 * x, r = i >> 3, ch = i & 7;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(out + (int64_t)(r0 + r) * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(slot + r * kMmaPitch + ch * 8);
  }
}

// ----------------------------------------------- scores and probabilities

// s = (q . k) / sqrt(D) + bias[j]: the TPU kernel's `s * scale + bias`,
// two roundings.
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// exp(x) as 2^(x log2 e) on the special-function unit (`ex2.approx`, about
// 2 ulp): the softmax's exponentials are most of the kernels' non-tensor
// work, and the full-accuracy expf costs several times as many
// instructions. p is normalised before any rounding to bf16 all the same.
__device__ __forceinline__ float exp_sfu(float x) {
  return exp2f(__fmul_rn(x, 1.4426950408889634f));
}

// p = exp(s - max) / denominator, the division as a product with the
// row's reciprocal denominator (one division per row, not per score).
__device__ __forceinline__ float prob(float s, float row_max,
                                      float inv_denom) {
  return __fmul_rn(exp_sfu(__fsub_rn(s, row_max)), inv_denom);
}

// The dropout factor at (i, j): 1 / (1 - rate) where the keep bit is set,
// else 0; rate 0 is threshold 0 with keep_scale 1, every bit kept.
__device__ __forceinline__ float drop_at(uint32_t key, uint32_t i, uint32_t j,
                                         uint32_t threshold,
                                         float keep_scale) {
  if (threshold == 0u) return 1.f;
  return keep_bit(key, i, j, threshold) ? keep_scale : 0.f;
}

// Sum over a quad's four lanes (each query row's sums), symmetric: the
// four lanes end with the same bits.
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// --------------------------------------------- the short kernels' rows

// One n-tile of a warp's products A B^T: the 16 rows of `a` (A operands
// over D: q rows for scores, g rows for dp) against rows [k0, k0 + 8) of a
// staged tile (K or V), each k-step's product in its own accumulator from
// zero and the four added in fp32 (((0 + 1) + (2 + 3))): the tensor
// cores' fp32 accumulation is not rounded as an IEEE sum is, and the stored
// p is held to the plain version at 1e-6, so a sum of 64 products is not
// left to one accumulator. B through `ldmatrix`.
__device__ __forceinline__ void abt_tile(float (&s)[4],
                                         const uint32_t (&a)[4][4],
                                         const bf16* tile, int k0, int lane) {
  uint32_t b[4][2];
  const bf16* p = tile + (k0 + (lane & 7)) * kMmaPitch + (lane >> 3) * 8;
  ldmatrix_x4(b[0][0], b[0][1], b[1][0], b[1][1], p);
  ldmatrix_x4(b[2][0], b[2][1], b[3][0], b[3][1], p + 32);
  float part[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    part[kk][0] = part[kk][1] = part[kk][2] = part[kk][3] = 0.f;
    mma_bf16(part[kk], a[kk], b[kk][0], b[kk][1]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[e] = __fadd_rn(__fadd_rn(part[0][e], part[1][e]),
                     __fadd_rn(part[2][e], part[3][e]));
}

// A chunk of NT n-tiles (8 NT keys, from key j0) of a warp's score rows:
// tile row t0 + 8n holds key j0 + 8n, `bias` the chunk's key bias. Keys at
// and past sk get -inf, and n-tiles wholly past sk are not computed.
template <int NT>
__device__ __forceinline__ void chunk_scores(float (&s)[NT][4],
                                             const uint32_t (&qa)[4][4],
                                             const bf16* ktile, int t0,
                                             const float* bias, int j0,
                                             int sk, float scale, int lane) {
  const int c = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (j0 + 8 * n < sk) {
      abt_tile(s[n], qa, ktile, t0 + 8 * n, lane);
      const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j0 + 8 * n + 2 * c + (e & 1) < sk;
        s[n][e] = in ? score(s[n][e], scale, (e & 1) ? bj.y : bj.x)
                     : -CUDART_INF_F;
      }
    } else {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = -CUDART_INF_F;
    }
  }
}

// Each query row's softmax max and reciprocal denominator for a lane's two
// rows (g and g + 8), over score rows that arrive in chunks of key order:
// `add_max` over every chunk, `quad_max`, then `add_sum` over every chunk again
// (from registers when the row is one chunk), then `finish`. The lane's
// partial sum adds its own elements in key order whatever the chunk size,
// and the quad merges exactly as `quad_sum`, so a forward and a backward
// that cut the row into different chunks get the same bits; p is formed
// afterwards from the final max and denominator (`prob`), so it is rounded
// where the TPU kernel rounds it.
struct RowSoftmax {
  float m[2], l[2];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }

  template <int NT>
  __device__ __forceinline__ void add_max(const float (&s)[NT][4]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      m[0] = fmaxf(m[0], fmaxf(s[n][0], s[n][1]));
      m[1] = fmaxf(m[1], fmaxf(s[n][2], s[n][3]));
    }
  }

  __device__ __forceinline__ void quad_max() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
  }

  template <int NT>
  __device__ __forceinline__ void add_sum(const float (&s)[NT][4]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e >> 1] = __fadd_rn(l[e >> 1],
                              exp_sfu(__fsub_rn(s[n][e], m[e >> 1])));
    }
  }

  __device__ __forceinline__ void finish() {
    l[0] = __frcp_rn(quad_sum(l[0]));
    l[1] = __frcp_rn(quad_sum(l[1]));
  }
};

// The n-tile count of a short kernel's register row: 2 (16 keys), 6 (48)
// or 12 (96, and every longer row in chunks of 96).
inline int row_tiles(int sk, int max_tiles) {
  const int need = (sk + 7) / 8;
  if (need <= 2) return 2;
  if (need <= 6 || max_tiles == 6) return 6;
  return 12;
}

}  // namespace fa
