// Tensor-core building blocks of the mid-length attention's bf16 kernels
// (midseq_attention_fwd.cu, midseq_attention_bwd.cu): cp.async staging of
// 64-row tiles, `ldmatrix` + `mma.sync.m16n8k16` (bf16 operands, fp32
// accumulation) products of one warp's 16 rows, and the score, softmax
// statistics and probability code that the forward, the dq kernel and the
// dk / dv kernel share, so all three form s and p with the same arithmetic
// in the same order.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane l is in group
// g = l / 4 and quad position c = l % 4. An fp32 accumulator tile [16 x 8]
// holds (row g, cols 2c, 2c + 1) in elements 0, 1 and (row g + 8, the same
// cols) in elements 2, 3. An A operand [16 x 16] holds, as bf16 pairs,
// (g, 2c..2c+1), (g + 8, 2c..2c+1), (g, 2c+8..2c+9), (g + 8, 2c+8..2c+9):
// two neighbouring accumulator tiles, rounded and packed, are one A
// operand, so probabilities never leave registers between the two products.
//
// Every sum that must repeat bit for bit (row max, denominator, the quad
// exchange) uses __fadd_rn / __fmul_rn, which the compiler never contracts
// into an FMA: the same inputs give the same bits in every kernel that
// includes this file, and the four lanes of a quad end with equal values.
#pragma once

#include "fused_attention_common.cuh"

namespace ms {

using bf16 = __nv_bfloat16;

constexpr int kD = fa::kHeadDim;  // 64
constexpr int kTileRows = 64;     // staged keys (or query rows) per tile
constexpr int kPitch = kD + 8;    // staged row pitch in bf16: 144 bytes, so
                                  // the 8 rows of an ldmatrix hit 32 banks
constexpr int kChunk = 32;        // keys (or query rows) per warp product
constexpr int kTileElems = kTileRows * kPitch;

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

// ---------------------------------------------------------------- staging

// Rows [r0, r0 + 64) of one head's [S, D] slice (row stride `stride`
// elements, 16-byte aligned rows) -> tile[64][kPitch], 16 bytes a thread
// with cp.async; rows at and past `rows` are zero-filled. The caller
// commits the group.
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* src,
                                           int64_t stride, int r0, int rows,
                                           int tid, int nthreads) {
  for (int i = tid; i < kTileRows * (kD / 8); i += nthreads) {
    const int r = i >> 3, ch = i & 7;
    const bool live = r0 + r < rows;
    const bf16* from = src + (int64_t)(live ? r0 + r : 0) * stride + ch * 8;
    cp_async_16(tile + r * kPitch + ch * 8, from, live ? 16 : 0);
  }
}

// One warp's 16 rows [r0, r0 + 16) of a head's [S, D] slice as the A
// operand of four k-steps over D (a[kk] covers d in [16 kk, 16 kk + 16)),
// read straight from global memory; rows at and past `rows` are zero.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4],
                                            const bf16* src, int64_t stride,
                                            int r0, int rows, int lane) {
  const int g = lane >> 2, c = lane & 3;
  const bool live0 = r0 + g < rows, live1 = r0 + g + 8 < rows;
  const uint32_t* row0 =
      reinterpret_cast<const uint32_t*>(src + (int64_t)(r0 + g) * stride);
  const uint32_t* row1 =
      reinterpret_cast<const uint32_t*>(src + (int64_t)(r0 + g + 8) * stride);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int w = kk * 8 + c;  // 32-bit word of columns 16 kk + 2c, +1
    a[kk][0] = live0 ? __ldg(row0 + w) : 0u;
    a[kk][1] = live1 ? __ldg(row1 + w) : 0u;
    a[kk][2] = live0 ? __ldg(row0 + w + 4) : 0u;
    a[kk][3] = live1 ? __ldg(row1 + w + 4) : 0u;
  }
}

// --------------------------------------------------------------- products

// acc[n] (n = 0..3: 16 rows x 8 columns each) = A [16 x 64] . B^T, with B
// rows [r0, r0 + 32) of a staged tile: 16 rows x 32 columns of A B^T. Each
// accumulator sums d in the order k-step 0, 1, 2, 3, from zero.
__device__ __forceinline__ void mma_abt(float (&acc)[4][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    uint32_t b[4][2];
    const bf16* p = tile + (r0 + n * 8 + (lane & 7)) * kPitch + (lane >> 3) * 8;
    ldmatrix_x4(b[0][0], b[0][1], b[1][0], b[1][1], p);
    ldmatrix_x4(b[2][0], b[2][1], b[3][0], b[3][1], p + 32);
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_bf16(acc[n], a[kk], b[kk][0], b[kk][1]);
  }
}

// acc[n] (n = 0..7: the 16 x 64 output in 8 column tiles) += A [16 x 32]
// . B, with B rows [r0, r0 + 32) of a staged tile (B's rows are the summed
// index): a[ks] is the A operand of rows r0 + 16 ks .. + 16.
__device__ __forceinline__ void mma_ab(float (&acc)[8][4],
                                       const uint32_t (&a)[2][4],
                                       const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0, b1, b2, b3;
      const bf16* p = tile +
                      (r0 + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          kPitch +
                      (np * 2 + (lane >> 4)) * 8;
      ldmatrix_x4_trans(b0, b1, b2, b3, p);
      mma_bf16(acc[2 * np], a[ks], b0, b1);
      mma_bf16(acc[2 * np + 1], a[ks], b2, b3);
    }
  }
}

// Accumulator tiles [16 x 32] (four n-tiles) -> two A operands [16 x 16]
// over the 32 columns, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[2][4],
                                       const float (&x)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    a[ks][0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    a[ks][1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    a[ks][2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
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
  return fa::keep_bit(key, i, j, threshold) ? keep_scale : 0.f;
}

// Query-major scores of one chunk: acc from `mma_abt` (rows are query rows,
// columns keys j0 + 8n + 2c + {0, 1}) -> s in place; keys at and past sk
// become -inf. `bias_tile` holds the bias of the staged tile's keys, and
// `col0` is the chunk's first column in the tile.
__device__ __forceinline__ void finish_scores(float (&s)[4][4],
                                              const float* bias_tile,
                                              int col0, int j0, int sk,
                                              float scale, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = col0 + n * 8 + 2 * (lane & 3);
    const float2 bj = *reinterpret_cast<const float2*>(bias_tile + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = j0 + n * 8 + 2 * (lane & 3) + e < sk;
      const float b = e ? bj.y : bj.x;
      s[n][e] = in ? score(s[n][e], scale, b) : -CUDART_INF_F;
      s[n][e + 2] = in ? score(s[n][e + 2], scale, b) : -CUDART_INF_F;
    }
  }
}

// The bias of keys [j0, j0 + 64) -> tile[64] with cp.async; keys at and
// past sk are zero-filled (and masked by `finish_scores`).
__device__ __forceinline__ void stage_bias(float* tile, const float* bias_b,
                                           int j0, int sk, int tid,
                                           int nthreads) {
  for (int i = tid; i < kTileRows; i += nthreads) {
    const bool in = j0 + i < sk;
    cp_async_4(tile + i, bias_b + (in ? j0 + i : 0), in ? 4 : 0);
  }
}

// Each query row's softmax max and denominator over the whole key row, for
// a lane's two rows (g and g + 8). Chunks arrive in key order; each lane
// keeps a running max and a running sum of exp(s - max), rescaled when the
// max grows; `finish` merges the four lanes of a quad and leaves the
// reciprocal of the denominator in `l`. Only the denominator is rescaled:
// p itself is formed afterwards from the final max and sum, so it is
// rounded where the TPU kernel rounds it.
struct RowStats {
  float m[2], l[2];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void update(const float (&s)[4][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float mn = fmaxf(m[r], mt);
      if (mn == -CUDART_INF_F) continue;  // every key so far masked
      float sum = __fmul_rn(l[r], exp_sfu(__fsub_rn(m[r], mn)));
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sum = __fadd_rn(sum, exp_sfu(__fsub_rn(s[n][2 * r], mn)));
        sum = __fadd_rn(sum, exp_sfu(__fsub_rn(s[n][2 * r + 1], mn)));
      }
      l[r] = sum;
      m[r] = mn;
    }
  }

  // After the last chunk: every lane of a quad holds its row's max and
  // reciprocal denominator (the merge is symmetric, so the four lanes agree
  // bit for bit).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], x);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], x);
        const float mn = fmaxf(m[r], mo);
        const float mine = m[r] == -CUDART_INF_F
                               ? 0.f
                               : __fmul_rn(l[r], exp_sfu(__fsub_rn(m[r], mn)));
        const float theirs = mo == -CUDART_INF_F
                                 ? 0.f
                                 : __fmul_rn(lo, exp_sfu(__fsub_rn(mo, mn)));
        l[r] = __fadd_rn(mine, theirs);
        m[r] = mn;
      }
      l[r] = __frcp_rn(l[r]);
    }
  }
};

// Sum over a quad's four lanes (each query row's rowsum), symmetric: the
// four lanes end with the same bits.
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The 16 x 64 fp32 accumulator of one warp -> rows [r0, r0 + 16) of a
// bf16 output with row stride `ld` (`out` points at the head's first
// column), rows < `rows` only.
__device__ __forceinline__ void store_rows(bf16* out, int64_t ld, int r0,
                                           int rows, const float (&acc)[8][4],
                                           int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows) continue;
    bf16* row = out + (int64_t)r * ld;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * c) =
          __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// The grid of a kernel over `rows` query rows (or keys) per (head, batch
// row): blocks of four warps (64 rows) when that gives at least two blocks
// per SM of the H100's 132, else one-warp blocks of 16 rows, so the cross
// attentions' few rows still spread over the card. `wide` and `narrow`
// launch the two instantiations on the grid they are given.
template <typename Wide, typename Narrow>
cudaError_t launch_by_width(int rows, int heads, int batch, Wide wide,
                            Narrow narrow) {
  if ((int64_t)((rows + 63) / 64) * heads * batch >= 2 * 132)
    wide(dim3((rows + 63) / 64, heads, batch));
  else
    narrow(dim3((rows + 15) / 16, heads, batch));
  return cudaGetLastError();
}

// 16-byte aligned pointer and row strides that keep every row 16-byte
// aligned: what cp.async and the 32-bit fragment loads need.
__host__ __forceinline__ bool aligned16(const void* p, int64_t s0,
                                        int64_t s1) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0;
}

}  // namespace ms
