// Fused short-sequence multi-head attention, forward, for NVIDIA Hopper
// (sm_90a): bf16 on the tensor cores (mma.sync), fp32 on scalar FMAs.
//
// Replaces the TPU kernel `crvqa_tpu/ops/fused_attention.py:_fwd_kernel`
// in both of its calls:
//
// - the primal (`fused_attention_fwd`, eval and serving, dropout rate 0;
//   `fused_attention_seeded` -> `_fa_primal` -> `pallas_call`);
// - the forward for grad (`fused_attention_fwd_train`; `_fas_fwd` ->
//   `_fa_fwd`): it also writes the pre-dropout probabilities p
//   [B, Sq, H*Sk] fp32 as the stored backward's residual (when given a
//   residual pointer) and applies dropout with the counter-hash keep mask of
//   `_keep_mask` (fused_attention_common.cuh), kept values scaled by
//   1 / (1 - rate), before p is rounded to the activation dtype.
//
// Per batch row b and head h:
//
//   s[i, j]   = (q_h[i] . k_h[j]) / sqrt(D) + bias[b, j]          (fp32)
//   p[i, :]   = softmax(s[i, :])                                   (fp32)
//   [train]     p_out[b, i, h*Sk + j] = p[i, j];  p = dropout(p)
//   out_h[i]  = sum_j round_to_activation_dtype(p[i, j]) * v_h[j]  (fp32 acc)
//
// q [B, Sq, H*D], k and v [B, Sk, H*D] are read in place from the projection
// layout (batch and row strides given; the last dimension is contiguous), so
// no head transpose is ever materialised. bias is [B, Sk] fp32 (0 for live
// keys, -10000 for padding). out is a contiguous [B, Sq, H*D] tensor in the
// activation dtype (fp32 or bf16). D is 64; H*Sq <= 1024 and H*Sk <= 1024,
// the scope of the JAX short-sequence predicate (models/layers.py:275).
//
// What bounds it on this card: memory. At LXMERT's shapes (Sq, Sk in {14,
// 36}, H = 12) a call does about 18 FLOP per byte of q/k/v/out at (36, 36),
// far under the ~295 FLOP per HBM byte at which the tensor cores would
// limit; the forward for grad adds the fp32 residual (4*B*Sq*H*Sk bytes,
// 16 MB at batch 256, (36, 36)). At serving batch 32 a call moves 2.8-7.1
// MB in bf16, 0.8-2.1 us of HBM time: a few waves of small blocks, so
// what sets the pace is latency (loads in flight, dependent instructions),
// not bandwidth.
//
// bf16 design (`fused_attention_fwd_mma_kernel`; the building blocks are
// fused_attention_common.cuh's, shared with the backward and the
// mid-length kernels):
//
// - one block per (head, batch row) and up to 8 query-row tiles of 16, one
//   warp each (Sq <= 85 at 12 heads: at most 6 warps), so K_h and V_h are
//   read from device memory once per (b, h);
// - q, K_h, V_h and the keys' bias staged together by 16-byte cp.async
//   into rows padded to 144 bytes (conflict-free `ldmatrix`), rows past Sq
//   and keys past Sk zero-filled;
// - scores S = Q K^T on mma.m16n8k16 into fp32, each k-step's product in
//   its own accumulator and the four added in fp32 (`fa::abt_tile`); the
//   whole score row stays in registers (NT n-tiles of 8 keys: 2, 6 or 12),
//   keys past Sk at -inf, so the softmax is single-pass like the TPU
//   kernel's: max and sum by quad shuffles, the denominator's reciprocal
//   once per row, exp on the special-function unit (`fa::RowSoftmax`,
//   `fa::prob`). A row longer than 96 keys (only at H <= 10) streams K in
//   chunks of 96 for the max, again for the sum and with V for the
//   context; the statistics do not depend on the chunking, so the
//   backward, which cuts rows into chunks of 48, rebuilds p bit for bit;
// - forward for grad: p goes from the registers to the residual as 8-byte
//   stores (4-byte when Sk is odd), and the keep bit is
//   `fa::keep_bit(keep_key_at(seed, b + batch0, col0), i, h*Sk + j,
//   threshold)`: batch0 and col0 place a rank's rows and heads in the
//   global mask (0 on one device);
// - context: p (after dropout) rounded to bf16 straight from the score
//   accumulators into A operands (`fa::pack_a`), V through
//   `ldmatrix.trans`; the warp's 16 x 64 output is staged in its own q rows
//   and written as 16-byte rows.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, device
// time under CUDA-graph replay): the primal takes 0.142 ms per LXMERT
// forward at batch 32 (34 calls; bound 0.047, scaled_dot_product_attention
// 0.502, the scalar kernel this design replaced 0.728); a (1, 1) call,
// which moves almost nothing, takes 3.0 us, the fixed cost of one launch
// and one load-compute-store round trip, against 3.3-5.2 us at LXMERT's
// shapes, so that fixed cost is most of the primal's time. The forward for
// grad takes 0.714 ms per stage-2 step at batch 256 (34 calls, dropout
// 0.1; bound 0.455, SDPA's forward under autograd 2.959, the scalar kernel
// 5.371): at (36, 36) it moves its 72.6 MB at 63% of the HBM rate.
//
// fp32 stays on the scalar kernel below (`fused_attention_fwd_kernel`):
// fp32 on the tensor cores is TF32, about three decimal digits, and the
// fp32 path is held to the plain version at 2e-5. Its design: one block per
// (8 query rows, head, batch row), one warp per query row; K_h and then V_h
// staged in tiles of 32 keys as fp32 (pitch D + 1); scores by fmaf chains,
// the row's softmax in shared memory (`fa::row_exp_sum`: expf and one
// division per score); each lane owns output columns lane and lane + 32.

#include "fused_attention_common.cuh"

namespace {

using fa::kHeadDim;
using fa::kMaxHeadsTimesSeq;
using fa::kPitch;

constexpr int kRows = 8;            // query rows (one warp each) per block
constexpr int kKeyTile = 32;        // keys per staged tile, one per lane

// Rows [j0, j0 + n) of one head's [S, D] slice -> tile[kKeyTile][kPitch] as
// fp32; tile rows at and past n are zeroed.
__device__ __forceinline__ void stage_tile(float* tile, const float* src,
                                           int64_t row_stride, int j0, int n) {
  for (int i = threadIdx.x; i < kKeyTile * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    tile[r * kPitch + c] =
        r < n ? src[(int64_t)(j0 + r) * row_stride + c] : 0.f;
  }
}

// kTrain = false: the primal (no residual, no dropout). kTrain = true: the
// forward for grad; `p_out` may be null (the recompute backward keeps no
// residual), and rate 0 is threshold 0 with keep_scale 1 (every bit kept,
// p * 1 == p).
template <bool kTrain>
__global__ void __launch_bounds__(kRows * 32)
    fused_attention_fwd_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int sq, int sk,
                               int heads,
                               int64_t q_sb, int64_t q_ss, int64_t k_sb,
                               int64_t k_ss, int64_t v_sb, int64_t v_ss,
                               float scale, float* __restrict__ p_out,
                               uint32_t seed, uint32_t batch0, uint32_t col0,
                                   uint32_t threshold,
                               float keep_scale) {
  extern __shared__ float smem[];
  float* tile = smem;                        // [kKeyTile][kPitch]
  float* qs = tile + kKeyTile * kPitch;      // [kRows][D]
  float* probs = qs + kRows * kHeadDim;      // [kRows][sk]

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + warp;
  const bool live = row < sq;  // uniform across the warp

  const float* qb = q + b * q_sb + h * kHeadDim;
  const float* kb = k + b * k_sb + h * kHeadDim;
  const float* vb = v + b * v_sb + h * kHeadDim;
  const float* bias_b = bias + (int64_t)b * sk;
  const float* qrow = qs + warp * kHeadDim;
  float* p = probs + warp * sk;

  for (int i = threadIdx.x; i < kRows * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    qs[i] = row0 + r < sq ? qb[(int64_t)(row0 + r) * q_ss + c] : 0.f;
  }

  // scores (the first barrier also publishes the staged q rows)
  for (int j0 = 0; j0 < sk; j0 += kKeyTile) {
    const int n = min(kKeyTile, sk - j0);
    __syncthreads();
    stage_tile(tile, kb, k_ss, j0, n);
    __syncthreads();
    if (live && lane < n) {
      const float* krow = tile + lane * kPitch;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) acc = fmaf(qrow[c], krow[c], acc);
      p[j0 + lane] = acc * scale + bias_b[j0 + lane];
    }
  }

  // softmax over this (row, head), fp32; p rounded to the activation dtype
  // before the context product, as the TPU kernel does
  if (live) {
    __syncwarp();
    const float denom = fa::row_exp_sum(p, sk, lane);
    if (kTrain) {
      // residual (pre-dropout p), then dropout keyed on the lane-blocked
      // column h * Sk + j, as crvqa_tpu/ops/fused_attention.py:205-211
      const uint32_t key = fa::keep_key_at(seed, (uint32_t)b + batch0, col0);
      float* res = p_out == nullptr
                       ? nullptr
                       : p_out + ((int64_t)b * sq + row) * heads * sk +
                             (int64_t)h * sk;
      for (int j = lane; j < sk; j += 32) {
        const float pf = p[j] / denom;
        if (res != nullptr) res[j] = pf;
        const bool keep = fa::keep_bit(key, (uint32_t)row,
                                       (uint32_t)(h * sk + j), threshold);
        p[j] = keep ? pf * keep_scale : 0.f;
      }
    } else {
      for (int j = lane; j < sk; j += 32)
        p[j] = p[j] / denom;
    }
    __syncwarp();
  }

  // context: lane owns output columns lane and lane + 32
  float acc0 = 0.f, acc1 = 0.f;
  for (int j0 = 0; j0 < sk; j0 += kKeyTile) {
    const int n = min(kKeyTile, sk - j0);
    __syncthreads();
    stage_tile(tile, vb, v_ss, j0, n);
    __syncthreads();
    if (live) {
      for (int r = 0; r < n; ++r) {
        const float pr = p[j0 + r];
        acc0 = fmaf(pr, tile[r * kPitch + lane], acc0);
        acc1 = fmaf(pr, tile[r * kPitch + lane + 32], acc1);
      }
    }
  }
  if (live) {
    float* o = out + ((int64_t)b * sq + row) * heads * kHeadDim + h * kHeadDim;
    o[lane] = acc0;
    o[lane + 32] = acc1;
  }
}

// ------------------------------------------------------- bf16, tensor cores

using fa::bf16;
using fa::kMmaPitch;

constexpr int kMaxWarps = 8;  // query-row tiles of 16 per block

// Dynamic shared memory of a bf16 block of `warps` warps with a register
// row of `nt` n-tiles: the block's q rows (each warp's 16 are also its
// output staging), one K and one V chunk of 8 nt keys, the chunk's bias.
// At most 46,464 bytes (8 warps, nt 12): under the 48 KB a launch may ask
// for without an attribute.
size_t mma_smem_bytes(int warps, int nt) {
  return sizeof(bf16) * (size_t)(16 * warps + 16 * nt) * kMmaPitch +
         sizeof(float) * 8 * nt;
}

// kTrain = false: the primal (no residual, no dropout). kTrain = true: the
// forward for grad; `p_out` may be null (the recompute backward keeps no
// residual); `p_pairs` says the residual takes 8-byte stores (Sk even, an
// 8-byte aligned start). Rate 0 is threshold 0 with keep_scale 1.
template <bool kTrain, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_attention_fwd_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const float* __restrict__ bias,
        bf16* __restrict__ out, int sq, int sk, int heads, int64_t q_sb,
        int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb,
        int64_t v_ss, float scale, float* __restrict__ p_out, int p_pairs,
        uint32_t seed, uint32_t batch0, uint32_t col0, uint32_t threshold,
            float keep_scale) {
  constexpr int kKeys = 8 * NT;  // keys a chunk (the register row)
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const int warps = blockDim.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [16 warps][kMmaPitch]
  bf16* ks = qs + 16 * warps * kMmaPitch;      // [kKeys][kMmaPitch]
  bf16* vs = ks + kKeys * kMmaPitch;           // [kKeys][kMmaPitch]
  float* bs = reinterpret_cast<float*>(vs + kKeys * kMmaPitch);  // [kKeys]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int block_row0 = blockIdx.x * warps * 16;
  const int row0 = block_row0 + warp * 16;  // this warp's query rows
  const bool live = row0 < sq;               // warp-uniform
  const bf16* kb = k + b * k_sb + h * fa::kHeadDim;
  const bf16* vb = v + b * v_sb + h * fa::kHeadDim;
  const float* bias_b = bias + (int64_t)b * sk;
  const int nch = (sk + kKeys - 1) / kKeys;

  // keys [j0, j0 + kKeys) of K (and V) and their bias -> shared memory,
  // with every cp.async of the block (the first call's include q's rows)
  auto stage_chunk = [&](int j0, bool with_v) {
    fa::stage_rows(ks, kb, k_ss, j0, kKeys, sk, tid, blockDim.x);
    if (with_v) fa::stage_rows(vs, vb, v_ss, j0, kKeys, sk, tid, blockDim.x);
    for (int i = tid; i < kKeys; i += blockDim.x) {
      const bool in = j0 + i < sk;
      fa::cp_async_4(bs + i, bias_b + (in ? j0 + i : 0), in ? 4 : 0);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<0>();
    __syncthreads();
  };
  auto restage = [&](int j0, bool with_v) {
    __syncthreads();  // every warp is done with the previous chunk
    stage_chunk(j0, with_v);
  };

  fa::stage_rows(qs, q + b * q_sb + h * fa::kHeadDim, q_ss, block_row0,
                 16 * warps, sq, tid, blockDim.x);
  stage_chunk(0, nch == 1);
  uint32_t qa[4][4];
  fa::load_a(qa, qs, warp * 16, lane);

  // softmax statistics over the whole row
  float s[NT][4];
  fa::RowSoftmax st;
  st.init();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch > 0) restage(ch * kKeys, false);
    if (live) {
      fa::chunk_scores<NT>(s, qa, ks, 0, bs, ch * kKeys, sk, scale, lane);
      st.add_max(s);
    }
  }
  if (live) st.quad_max();
  if (nch == 1) {
    if (live) st.add_sum(s);
  } else {
    for (int ch = 0; ch < nch; ++ch) {
      restage(ch * kKeys, false);
      if (live) {
        fa::chunk_scores<NT>(s, qa, ks, 0, bs, ch * kKeys, sk, scale, lane);
        st.add_sum(s);
      }
    }
  }
  if (live) st.finish();

  // p, the residual, dropout, and the context P V
  const uint32_t key = fa::keep_key_at(seed, (uint32_t)b + batch0, col0);
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const int j0 = ch * kKeys;
    if (nch > 1) {
      restage(j0, true);
      if (live)
        fa::chunk_scores<NT>(s, qa, ks, 0, bs, j0, sk, scale, lane);
    }
    if (!live) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fa::prob(s[n][e], st.m[e >> 1],
                                                      st.l[e >> 1]);
    }
    if (kTrain) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + g + 8 * r;
        if (p_out != nullptr && i < sq) {
          float* res = p_out + ((int64_t)b * sq + i) * heads * sk +
                       (int64_t)h * sk + j0;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int j = 8 * n + 2 * c;  // in the chunk
            if (j0 + j >= sk) continue;
            if (p_pairs)  // Sk even: j + 1 < Sk too
              *reinterpret_cast<float2*>(res + j) =
                  make_float2(s[n][2 * r], s[n][2 * r + 1]);
            else {
              res[j] = s[n][2 * r];
              if (j0 + j + 1 < sk) res[j + 1] = s[n][2 * r + 1];
            }
          }
        }
      }
      if (threshold != 0u) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = __fmul_rn(
                s[n][e],
                fa::drop_at(key, (uint32_t)(row0 + g + 8 * (e >> 1)),
                            (uint32_t)(h * sk + j0 + 8 * n + 2 * c + (e & 1)),
                            threshold, keep_scale));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT / 2; ++t) {
      if (j0 + 16 * t < sk) {
        uint32_t pa[4];
        fa::pack_a(pa, s[2 * t], s[2 * t + 1]);
        fa::mma_ab16(o, pa, vs, 16 * t, lane);
      }
    }
  }
  if (live) {
    const int64_t ld = (int64_t)heads * fa::kHeadDim;
    fa::store_tile(out + (int64_t)b * sq * ld + h * fa::kHeadDim, ld, row0,
                   sq, o, qs + warp * 16 * kMmaPitch, lane);
  }
}

template <bool kTrain, int NT>
void launch_mma(dim3 grid, int warps, const void* q, const void* k,
                const void* v, const float* bias, void* out, int sq, int sk,
                int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                int64_t k_ss, int64_t v_sb, int64_t v_ss, float scale,
                float* p_out, int p_pairs, uint32_t seed, uint32_t batch0,
                uint32_t col0, uint32_t threshold,
                float keep_scale, cudaStream_t stream) {
  fused_attention_fwd_mma_kernel<kTrain, NT>
      <<<grid, warps * 32, mma_smem_bytes(warps, NT), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), sq, sk,
          heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, p_out, p_pairs,
          seed, batch0, col0, threshold, keep_scale);
}

template <bool kTrain>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int batch, int sq, int sk, int heads, int head_dim,
           int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
           int64_t v_sb, int64_t v_ss, int is_bf16, float* p_out,
           uint32_t seed, uint32_t batch0, uint32_t col0, uint32_t threshold,
               float keep_scale,
           void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || sq < 1 ||
      sk < 1 || heads < 1 || heads * sq > kMaxHeadsTimesSeq ||
      heads * sk > kMaxHeadsTimesSeq)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!fa::aligned16(q, q_sb, q_ss) || !fa::aligned16(k, k_sb, k_ss) ||
        !fa::aligned16(v, v_sb, v_ss))
      return (int)cudaErrorMisalignedAddress;
    const int tiles = (sq + 15) / 16;
    const int warps = tiles < kMaxWarps ? tiles : kMaxWarps;
    const dim3 grid((tiles + warps - 1) / warps, heads, batch);
    const int p_pairs =
        p_out != nullptr && sk % 2 == 0 &&
        reinterpret_cast<uintptr_t>(p_out) % 8 == 0;
#define FA_FWD_MMA_ARGS                                                     \
  grid, warps, q, k, v, bias, out, sq, sk, heads, q_sb, q_ss, k_sb, k_ss,   \
      v_sb, v_ss, scale, p_out, p_pairs, seed, batch0, col0, threshold,   \
      keep_scale, s
    switch (fa::row_tiles(sk, 12)) {
      case 2: launch_mma<kTrain, 2>(FA_FWD_MMA_ARGS); break;
      case 6: launch_mma<kTrain, 6>(FA_FWD_MMA_ARGS); break;
      default: launch_mma<kTrain, 12>(FA_FWD_MMA_ARGS); break;
    }
#undef FA_FWD_MMA_ARGS
    return (int)cudaGetLastError();
  }
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  const dim3 block(kRows * 32);
  const size_t smem = sizeof(float) * (kKeyTile * kPitch + kRows * kHeadDim +
                                       (size_t)kRows * sk);
  fused_attention_fwd_kernel<kTrain><<<grid, block, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), sq, sk,
      heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, p_out, seed, batch0,
          col0,
      threshold, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the primal kernel on `stream` and returns cudaGetLastError() (0
// when the launch was accepted). Pointers are device pointers; strides are
// in elements. `is_bf16` selects bf16 (1) or fp32 (0) for q, k, v and out.
int fused_attention_fwd(const void* q, const void* k, const void* v,
                        const float* bias, void* out, int batch, int sq,
                        int sk, int heads, int head_dim, int64_t q_sb,
                        int64_t q_ss, int64_t k_sb, int64_t k_ss,
                        int64_t v_sb, int64_t v_ss, int is_bf16,
                        void* stream) {
  return launch<false>(q, k, v, bias, out, batch, sq, sk, heads, head_dim,
                       q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, is_bf16, nullptr,
                       0u, 0u, 0u, 0u, 1.f, stream);
}

// The forward for grad: as above, plus the fp32 residual p_out
// [B, Sq, H*Sk] (contiguous; null to skip it) and dropout from `seed` (the
// int32 seed's bits), `threshold` and `keep_scale` = 1 / (1 - rate), the
// keep mask keyed on global batch row b + `batch0` and lane-blocked column
// `col0` + h*Sk + j (`batch0`, `col0`: the first global row and column of
// a data- or tensor-parallel rank's slice; 0 on one device).
int fused_attention_fwd_train(const void* q, const void* k, const void* v,
                              const float* bias, void* out, float* p_out,
                              int batch, int sq, int sk, int heads,
                              int head_dim, int64_t q_sb, int64_t q_ss,
                              int64_t k_sb, int64_t k_ss, int64_t v_sb,
                              int64_t v_ss, int is_bf16, uint32_t seed,
                              uint32_t batch0, uint32_t col0,
                              uint32_t threshold, float keep_scale,
                              void* stream) {
  return launch<true>(q, k, v, bias, out, batch, sq, sk, heads, head_dim,
                      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, is_bf16, p_out,
                      seed, batch0, col0, threshold, keep_scale, stream);
}

const char* fused_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
