// Tensor-core building blocks of the mid-length attention's bf16 kernels
// (midseq_attention_fwd.cu, midseq_attention_bwd.cu): cp.async staging of
// 64-row tiles, `ldmatrix` + `mma.sync.m16n8k16` (bf16 operands, fp32
// accumulation) products of one warp's 16 rows, and the score, softmax
// statistics and probability code that the forward, the dq kernel and the
// dk / dv kernel share, so all three form s and p with the same arithmetic
// in the same order.
//
// The PTX wrappers, the fragment layout and the score / exp / prob code
// live in fused_attention_common.cuh, shared with the short kernels.
#pragma once

#include "fused_attention_common.cuh"

namespace ms {

using fa::bf16;

constexpr int kD = fa::kHeadDim;       // 64
constexpr int kTileRows = 64;          // staged keys (or query rows) a tile
constexpr int kPitch = fa::kMmaPitch;  // staged row pitch: 144 bytes
constexpr int kChunk = 32;             // keys (or query rows) a warp product
constexpr int kTileElems = kTileRows * kPitch;

using fa::aligned16;
using fa::cp_async_16;
using fa::cp_async_4;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::drop_at;
using fa::exp_sfu;
using fa::ldmatrix_x4;
using fa::ldmatrix_x4_trans;
using fa::mma_bf16;
using fa::pack_bf16;
using fa::prob;
using fa::quad_sum;
using fa::score;

// ---------------------------------------------------------------- staging

// Rows [r0, r0 + 64) of one head's [S, D] slice -> tile[64][kPitch]
// (`fa::stage_rows`); rows at and past `rows` are zero-filled. The caller
// commits the group.
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* src,
                                           int64_t stride, int r0, int rows,
                                           int tid, int nthreads) {
  fa::stage_rows(tile, src, stride, r0, kTileRows, rows, tid, nthreads);
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
  for (int ks = 0; ks < 2; ++ks)
    fa::mma_ab16(acc, a[ks], tile, r0 + 16 * ks, lane);
}

// Accumulator tiles [16 x 32] (four n-tiles) -> two A operands [16 x 16]
// over the 32 columns, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[2][4],
                                       const float (&x)[4][4]) {
  fa::pack_a(a[0], x[0], x[1]);
  fa::pack_a(a[1], x[2], x[3]);
}

// ----------------------------------------------- scores and probabilities

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

}  // namespace ms
