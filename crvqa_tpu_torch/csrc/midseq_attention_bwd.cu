// Mid-length multi-head attention, recompute backward, for NVIDIA Hopper
// (sm_90a): bf16 on the tensor cores (mma.sync), fp32 on scalar FMAs.
//
// Replaces the TPU kernel `crvqa_tpu/ops/midseq_attention.py:_bwd_kernel`
// (`_ms_bwd` -> `_call` -> `pallas_call`): the backward of the attentions
// mPLUG trains through out of the short kernel's scope, namely the CLIP
// ViT's (577, 577) self-attention, the fusion encoder's (25, 577) cross-
// attention, the stride layer's (602, 602) joint self-attention and the
// decoder's grouped (A*L, 602) cross-attention over the unreplicated memory.
//
// Nothing but q, k, v, the bias and the seed is saved by the forward. Per
// batch row b and head h, with g the output cotangent already cast to the
// activation dtype T:
//
//   s[i, j]  = (q[i] . k[j]) / sqrt(D) + bias[b, j]                  (fp32)
//   p[i, :]  = exp(s[i, :] - max) / sum(exp(s[i, :] - max))          (fp32)
//   drop     = keep(b, h, i, j) ? 1 / (1 - rate) : 0        (1 at rate 0)
//   dv[j]    = sum_i round_T(p[i, j] * drop) * g[i]                (fp32 acc)
//   dp[i, j] = (g[i] . v[j]) * drop                                  (fp32)
//   rowsum_i = sum_j dp[i, j] * p[i, j]                              (fp32)
//   ds[i, j] = round_T((dp[i, j] - rowsum_i) * p[i, j] / sqrt(D))
//   dq[i]    = sum_j ds[i, j] * k[j]                               (fp32 acc)
//   dk[j]    = sum_i ds[i, j] * q[i]                               (fp32 acc)
//
// with dq, dk, dv rounded to T once at the end: the TPU kernel's rounding
// points. rowsum is the fp32 sum of dp * p as `_bwd_kernel` forms it, not
// the shortcut g . out, which would read a bf16-rounded output. The keep
// bit is the forward's (`fa::keep_key(seed, b + batch0, h + head0)`,
// plain key index j).
// The TPU wrapper pads Sq to 16 and Sk to 128 with a -1e30 bias; here
// every loop is bounded by Sq and Sk instead. q, k, v, g are read in place
// through their batch and row strides (last dimension contiguous); dq, dk,
// dv are contiguous. D is 64.
//
// What bounds it on this card: arithmetic. Five products of 2*B*H*Sq*Sk*D
// FLOPs (scores, dp, dv, dq, dk) against q, k, v, g read and dq, dk, dv
// written once: at (577, 577), batch 16, bf16, 20.5 GFLOP, 20.7 us at 989
// TFLOP/s against 18.5 us at 3.35 TB/s (chip_smoke.py
// `_midseq_bwd_bound_terms`).
//
// Structure (both dtypes). dq sums over keys and is owned by query rows;
// dk and dv sum over query rows and are owned by keys. No float atomics
// (results repeat bit for bit across runs), so two kernels in one stream
// order: a dq kernel over query tiles that also writes each row's max,
// softmax denominator and rowsum to an fp32 scratch [B, H, 3, Sq], then a
// dk / dv kernel over key tiles that rebuilds p and ds from that scratch.
//
// bf16 design (midseq_mma_common.cuh; every product a bf16 mma.m16n8k16
// with fp32 accumulation, scores in registers in the accumulator layout):
//
// 1. `midseq_bwd_dq_mma_kernel`, one block per (64 query rows, head, batch
//    row), 4 warps x 16 rows (one-warp blocks when there are under two
//    blocks per SM), q and g rows held as A operands in registers. Three
//    passes over K (and V) tiles of 64 keys, staged by cp.async into a
//    two-stage ring: (1) S = Q K^T and each row's max and denominator with
//    the forward's own `ms::RowStats`, so p is the forward's bit for bit;
//    (2) S again, p, dP = G V^T, rowsum += dp * p; (3) S, p, dP again, ds
//    rounded to bf16 into A operands, dQ += dS K (K through
//    `ldmatrix.trans`). Its scratch holds each row's max, reciprocal
//    denominator and rowsum (the fp32 kernels' holds the denominator).
// 2. `midseq_bwd_dkv_mma_kernel`, one block per (64 keys, head, batch
//    row), 4 warps x 16 keys, k and v rows held as A operands. Q and G
//    tiles of 64 query rows and their scratch statistics stream through a
//    two-stage cp.async ring. Per 32 query rows: S^T = K Q^T (the same
//    products, summed over D in the same order as the forward's Q K^T, so
//    the same s and p), dP^T = V G^T, then p * drop and ds rounded to
//    bf16 into A operands, dV += P~^T G and dK += dS^T Q (G and Q through
//    `ldmatrix.trans`).
//
// fp32 stays on the scalar kernels below: fp32 on the tensor cores is
// TF32, about three decimal digits, and the fp32 path is held to the plain
// version at 2e-5. Their design: `midseq_bwd_dq_kernel`, one block per (16
// query rows, head, batch row), 8 warps x 2 rows, K tiles -> scores and
// probabilities in shared memory (16 x Sk fp32), V tiles -> dp beside them
// (a second plane) and rowsum, then ds in place and K tiles again for dq
// (two 16 x 602 planes take 77 KB; the 227 KB limit bounds Sk at about
// 1700, the wrapper checks); `midseq_bwd_dkv_kernel`, one block per (16
// keys, head, batch row), q and g streamed in tiles of 32 rows, one lane
// per query row rebuilding p and ds from the scratch statistics.

#include "midseq_mma_common.cuh"

namespace {

using fa::from_f32;
using fa::kHeadDim;
using fa::to_f32;

constexpr int kWarps = 8;
constexpr int kPerWarp = 2;
constexpr int kOwned = kWarps * kPerWarp;  // query rows (or keys) per block
constexpr int kTile = 32;                  // staged keys (or query rows)
constexpr int kPitch = kHeadDim + 1;       // staged row pitch in floats
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper

size_t dq_smem_bytes(int sk) {
  return sizeof(float) * ((size_t)kTile * kPitch +
                          2 * (size_t)kOwned * kHeadDim +
                          2 * (size_t)kOwned * sk);
}

// Rows [j0, j0 + n) of one head's [S, D] slice -> tile[kTile][kPitch] as
// fp32; tile rows at and past n are zeroed.
template <typename T>
__device__ __forceinline__ void stage_tile(float* tile, const T* src,
                                           int64_t row_stride, int j0, int n) {
  for (int i = threadIdx.x; i < kTile * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    tile[r * kPitch + c] =
        r < n ? to_f32(src[(int64_t)(j0 + r) * row_stride + c]) : 0.f;
  }
}

// Rows [r0, r0 + kOwned) of one head's [S, D] slice -> dst[kOwned][D] as
// fp32 (dense pitch: read as broadcasts); rows at and past `rows` zeroed.
template <typename T>
__device__ __forceinline__ void stage_owned(float* dst, const T* src,
                                            int64_t row_stride, int r0,
                                            int rows) {
  for (int i = threadIdx.x; i < kOwned * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[i] = r0 + r < rows ? to_f32(src[(int64_t)(r0 + r) * row_stride + c])
                           : 0.f;
  }
}

// One query row after the score pass: softmax in place (pre-dropout, fp32,
// the forward's own arithmetic); returns the row's max and denominator.
__device__ __forceinline__ void softmax_row(float* p, int sk, int lane,
                                            float* row_max, float* denom) {
  *row_max = fa::row_max(p, sk, lane);
  const float d = fa::row_exp_sum(p, sk, lane);
  for (int j = lane; j < sk; j += 32) p[j] = p[j] / d;
  *denom = d;
}

// rate 0 is threshold 0 with keep_scale 1: every bit kept, drop == 1.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    midseq_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ g, T* __restrict__ dq,
                         float* __restrict__ stats, int sq, int sk, int heads,
                         int64_t q_sb, int64_t q_ss, int64_t k_sb,
                         int64_t k_ss, int64_t v_sb, int64_t v_ss,
                         int64_t g_sb, int64_t g_ss, float scale,
                         uint32_t seed, uint32_t batch0, uint32_t head0,
                             uint32_t threshold,
                         float keep_scale) {
  extern __shared__ float smem[];
  float* tile = smem;                      // [kTile][kPitch]
  float* qs = tile + kTile * kPitch;       // [kOwned][D]
  float* gs = qs + kOwned * kHeadDim;      // [kOwned][D]
  float* probs = gs + kOwned * kHeadDim;   // [kOwned][sk]: s, then p
  float* dps = probs + (size_t)kOwned * sk;  // [kOwned][sk]: dp, then ds

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kOwned;
  const int r0 = warp * kPerWarp;  // this warp's local rows r0, r0 + 1
  const int row_a = row0 + r0, row_b = row_a + 1;
  const bool live_a = row_a < sq, live_b = row_b < sq;  // warp-uniform

  const T* kb = k + b * k_sb + h * kHeadDim;
  const T* vb = v + b * v_sb + h * kHeadDim;
  const float* bias_b = bias + (int64_t)b * sk;
  const float* qa = qs + r0 * kHeadDim;
  const float* qb_row = qa + kHeadDim;
  const float* ga = gs + r0 * kHeadDim;
  const float* gb_row = ga + kHeadDim;
  float* pa = probs + (size_t)r0 * sk;
  float* pb = pa + sk;
  float* da = dps + (size_t)r0 * sk;
  float* db = da + sk;

  stage_owned(qs, q + b * q_sb + h * kHeadDim, q_ss, row0, sq);
  stage_owned(gs, g + b * g_sb + h * kHeadDim, g_ss, row0, sq);

  // scores (the first barrier also publishes the staged q and g rows)
  for (int j0 = 0; j0 < sk; j0 += kTile) {
    const int n = min(kTile, sk - j0);
    __syncthreads();
    stage_tile(tile, kb, k_ss, j0, n);
    __syncthreads();
    if (live_a && lane < n) {
      const float* krow = tile + lane * kPitch;
      float acc_a = 0.f, acc_b = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        const float kc = krow[c];
        acc_a = fmaf(qa[c], kc, acc_a);
        acc_b = fmaf(qb_row[c], kc, acc_b);
      }
      const float bj = bias_b[j0 + lane];
      pa[j0 + lane] = acc_a * scale + bj;
      if (live_b) pb[j0 + lane] = acc_b * scale + bj;
    }
  }

  // pre-dropout probabilities of each live row of this warp, fp32
  float max_a = 0.f, den_a = 1.f, max_b = 0.f, den_b = 1.f;
  if (live_a) {
    __syncwarp();
    softmax_row(pa, sk, lane, &max_a, &den_a);
    if (live_b) softmax_row(pb, sk, lane, &max_b, &den_b);
    __syncwarp();
  }

  // dp = (g v^T) * drop, and each row's sum of dp * p
  const uint32_t key = fa::keep_key(seed, (uint32_t)b + batch0,
      (uint32_t)h + head0);
  float part_a = 0.f, part_b = 0.f;
  for (int j0 = 0; j0 < sk; j0 += kTile) {
    const int n = min(kTile, sk - j0);
    __syncthreads();
    stage_tile(tile, vb, v_ss, j0, n);
    __syncthreads();
    if (live_a && lane < n) {
      const float* vrow = tile + lane * kPitch;
      float acc_a = 0.f, acc_b = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        const float vc = vrow[c];
        acc_a = fmaf(ga[c], vc, acc_a);
        acc_b = fmaf(gb_row[c], vc, acc_b);
      }
      const int j = j0 + lane;
      const float drop_a =
          fa::keep_bit(key, (uint32_t)row_a, (uint32_t)j, threshold)
              ? keep_scale : 0.f;
      const float dp_a = __fmul_rn(acc_a, drop_a);
      da[j] = dp_a;
      part_a += dp_a * pa[j];
      if (live_b) {
        const float drop_b =
            fa::keep_bit(key, (uint32_t)row_b, (uint32_t)j, threshold)
                ? keep_scale : 0.f;
        const float dp_b = __fmul_rn(acc_b, drop_b);
        db[j] = dp_b;
        part_b += dp_b * pb[j];
      }
    }
  }

  // ds in place of dp, rounded to the activation dtype; the row statistics
  // go to the scratch for the dk / dv kernel
  if (live_a) {
    const float rs_a = fa::warp_sum(part_a);
    const float rs_b = fa::warp_sum(part_b);
    __syncwarp();
    for (int j = lane; j < sk; j += 32)
      da[j] = to_f32(from_f32<T>((da[j] - rs_a) * pa[j] * scale));
    if (live_b)
      for (int j = lane; j < sk; j += 32)
        db[j] = to_f32(from_f32<T>((db[j] - rs_b) * pb[j] * scale));
    if (lane == 0) {
      float* st = stats + ((int64_t)b * heads + h) * 3 * sq;
      st[row_a] = max_a;
      st[sq + row_a] = den_a;
      st[2 * sq + row_a] = rs_a;
      if (live_b) {
        st[row_b] = max_b;
        st[sq + row_b] = den_b;
        st[2 * sq + row_b] = rs_b;
      }
    }
    __syncwarp();
  }

  // dq = ds k: lane owns output columns lane and lane + 32 of both rows
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
  for (int j0 = 0; j0 < sk; j0 += kTile) {
    const int n = min(kTile, sk - j0);
    __syncthreads();
    stage_tile(tile, kb, k_ss, j0, n);
    __syncthreads();
    if (live_a) {
      const float* drow_a = da + j0;
      const float* drow_b = db + j0;
      for (int r = 0; r < n; ++r) {
        const float k0 = tile[r * kPitch + lane];
        const float k1 = tile[r * kPitch + lane + 32];
        const float wa = drow_a[r];
        a0 = fmaf(wa, k0, a0);
        a1 = fmaf(wa, k1, a1);
        if (live_b) {
          const float wb = drow_b[r];
          b0 = fmaf(wb, k0, b0);
          b1 = fmaf(wb, k1, b1);
        }
      }
    }
  }
  const int64_t ld = (int64_t)heads * kHeadDim;
  if (live_a) {
    T* o = dq + ((int64_t)b * sq + row_a) * ld + h * kHeadDim;
    o[lane] = from_f32<T>(a0);
    o[lane + 32] = from_f32<T>(a1);
  }
  if (live_b) {
    T* o = dq + ((int64_t)b * sq + row_b) * ld + h * kHeadDim;
    o[lane] = from_f32<T>(b0);
    o[lane + 32] = from_f32<T>(b1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    midseq_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias,
                          const T* __restrict__ g,
                          const float* __restrict__ stats,
                          T* __restrict__ dk, T* __restrict__ dv, int sq,
                          int sk, int heads, int64_t q_sb, int64_t q_ss,
                          int64_t k_sb, int64_t k_ss, int64_t v_sb,
                          int64_t v_ss, int64_t g_sb, int64_t g_ss,
                          float scale, uint32_t seed, uint32_t batch0,
                          uint32_t head0, uint32_t threshold,
                          float keep_scale) {
  __shared__ float ks[kOwned * kHeadDim];    // this block's keys
  __shared__ float vs[kOwned * kHeadDim];
  __shared__ float qt[kTile * kPitch];       // a tile of query rows
  __shared__ float gt[kTile * kPitch];
  __shared__ float st[3 * kTile];            // their max, denominator, rowsum
  __shared__ float wbuf[kWarps * 4 * kTile]; // per warp: p_t and ds, 2 keys

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * kOwned;
  const int r0 = warp * kPerWarp;
  const int j_a = key0 + r0, j_b = j_a + 1;
  const bool live_a = j_a < sk, live_b = j_b < sk;  // warp-uniform

  const T* qb = q + b * q_sb + h * kHeadDim;
  const T* gb = g + b * g_sb + h * kHeadDim;
  const float* stats_bh = stats + ((int64_t)b * heads + h) * 3 * sq;
  const float* ka = ks + r0 * kHeadDim;
  const float* kb_row = ka + kHeadDim;
  const float* va = vs + r0 * kHeadDim;
  const float* vb_row = va + kHeadDim;
  float* w = wbuf + warp * 4 * kTile;

  stage_owned(ks, k + b * k_sb + h * kHeadDim, k_ss, key0, sk);
  stage_owned(vs, v + b * v_sb + h * kHeadDim, v_ss, key0, sk);
  const float bias_a = live_a ? bias[(int64_t)b * sk + j_a] : 0.f;
  const float bias_bb = live_b ? bias[(int64_t)b * sk + j_b] : 0.f;
  const uint32_t key = fa::keep_key(seed, (uint32_t)b + batch0,
      (uint32_t)h + head0);

  // lane owns columns lane and lane + 32 of dv and dk of both keys
  float dva0 = 0.f, dva1 = 0.f, dvb0 = 0.f, dvb1 = 0.f;
  float dka0 = 0.f, dka1 = 0.f, dkb0 = 0.f, dkb1 = 0.f;

  for (int i0 = 0; i0 < sq; i0 += kTile) {
    const int n = min(kTile, sq - i0);
    __syncthreads();  // also publishes ks / vs before the first use
    stage_tile(qt, qb, q_ss, i0, n);
    stage_tile(gt, gb, g_ss, i0, n);
    for (int t = threadIdx.x; t < 3 * kTile; t += blockDim.x) {
      const int which = t / kTile, r = t % kTile;
      st[t] = r < n ? stats_bh[(int64_t)which * sq + i0 + r] : 1.f;
    }
    __syncthreads();
    if (live_a) {
      float pt_a = 0.f, ds_a = 0.f, pt_b = 0.f, ds_b = 0.f;
      if (lane < n) {
        const float* qrow = qt + lane * kPitch;
        const float* grow = gt + lane * kPitch;
        float s_a = 0.f, s_b = 0.f, d_a = 0.f, d_b = 0.f;
#pragma unroll
        for (int c = 0; c < kHeadDim; ++c) {
          const float qc = qrow[c], gc = grow[c];
          s_a = fmaf(qc, ka[c], s_a);
          s_b = fmaf(qc, kb_row[c], s_b);
          d_a = fmaf(gc, va[c], d_a);
          d_b = fmaf(gc, vb_row[c], d_b);
        }
        const float row_max = st[lane], denom = st[kTile + lane];
        const float rowsum = st[2 * kTile + lane];
        const uint32_t i = (uint32_t)(i0 + lane);
        {
          const float sc = s_a * scale + bias_a;
          const float p = expf(sc - row_max) / denom;
          const float drop =
              fa::keep_bit(key, i, (uint32_t)j_a, threshold) ? keep_scale
                                                             : 0.f;
          pt_a = to_f32(from_f32<T>(p * drop));
          ds_a = to_f32(from_f32<T>((__fmul_rn(d_a, drop) - rowsum) * p * scale));
        }
        if (live_b) {
          const float sc = s_b * scale + bias_bb;
          const float p = expf(sc - row_max) / denom;
          const float drop =
              fa::keep_bit(key, i, (uint32_t)j_b, threshold) ? keep_scale
                                                             : 0.f;
          pt_b = to_f32(from_f32<T>(p * drop));
          ds_b = to_f32(from_f32<T>((__fmul_rn(d_b, drop) - rowsum) * p * scale));
        }
      }
      w[lane] = pt_a;
      w[kTile + lane] = ds_a;
      w[2 * kTile + lane] = pt_b;
      w[3 * kTile + lane] = ds_b;
      __syncwarp();
      for (int r = 0; r < n; ++r) {
        const float g0 = gt[r * kPitch + lane];
        const float g1 = gt[r * kPitch + lane + 32];
        const float q0 = qt[r * kPitch + lane];
        const float q1 = qt[r * kPitch + lane + 32];
        const float pta = w[r], dsa = w[kTile + r];
        const float ptb = w[2 * kTile + r], dsb = w[3 * kTile + r];
        dva0 = fmaf(pta, g0, dva0);
        dva1 = fmaf(pta, g1, dva1);
        dka0 = fmaf(dsa, q0, dka0);
        dka1 = fmaf(dsa, q1, dka1);
        dvb0 = fmaf(ptb, g0, dvb0);
        dvb1 = fmaf(ptb, g1, dvb1);
        dkb0 = fmaf(dsb, q0, dkb0);
        dkb1 = fmaf(dsb, q1, dkb1);
      }
    }
  }
  const int64_t ld = (int64_t)heads * kHeadDim;
  if (live_a) {
    const int64_t o = ((int64_t)b * sk + j_a) * ld + h * kHeadDim;
    dv[o + lane] = from_f32<T>(dva0);
    dv[o + lane + 32] = from_f32<T>(dva1);
    dk[o + lane] = from_f32<T>(dka0);
    dk[o + lane + 32] = from_f32<T>(dka1);
  }
  if (live_b) {
    const int64_t o = ((int64_t)b * sk + j_b) * ld + h * kHeadDim;
    dv[o + lane] = from_f32<T>(dvb0);
    dv[o + lane + 32] = from_f32<T>(dvb1);
    dk[o + lane] = from_f32<T>(dkb0);
    dk[o + lane + 32] = from_f32<T>(dkb1);
  }
}


// ------------------------------------------------------- bf16, tensor cores

template <int kBlockWarps>
__global__ void __launch_bounds__(kBlockWarps * 32)
    midseq_bwd_dq_mma_kernel(const ms::bf16* __restrict__ q,
                             const ms::bf16* __restrict__ k,
                             const ms::bf16* __restrict__ v,
                             const float* __restrict__ bias,
                             const ms::bf16* __restrict__ g,
                             ms::bf16* __restrict__ dq,
                             float* __restrict__ stats, int sq, int sk,
                             int heads, int64_t q_sb, int64_t q_ss,
                             int64_t k_sb, int64_t k_ss, int64_t v_sb,
                             int64_t v_ss, int64_t g_sb, int64_t g_ss,
                             float scale, uint32_t seed, uint32_t batch0,
                             uint32_t head0, uint32_t threshold,
                             float keep_scale) {
  __shared__ __align__(128) ms::bf16 ks[2][ms::kTileElems];
  __shared__ __align__(128) ms::bf16 vs[2][ms::kTileElems];
  __shared__ __align__(16) float bs[2][ms::kTileRows];  // the keys' bias

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kBlockWarps + warp) * 16;  // warp rows
  const bool live = row0 < sq;  // warp-uniform
  const ms::bf16* kb = k + b * k_sb + h * ms::kD;
  const ms::bf16* vb = v + b * v_sb + h * ms::kD;
  const float* bias_b = bias + (int64_t)b * sk;
  const uint32_t key = fa::keep_key(seed, (uint32_t)b + batch0,
      (uint32_t)h + head0);
  const int gq = lane >> 2, c = lane & 3;

  uint32_t qa[4][4], ga[4][4];
  ms::load_a_rows(qa, q + b * q_sb + h * ms::kD, q_ss, row0, sq, lane);
  ms::load_a_rows(ga, g + b * g_sb + h * ms::kD, g_ss, row0, sq, lane);

  // steps [0, nt): K tiles (statistics); [nt, 2 nt): K and V (rowsum);
  // [2 nt, 3 nt): K and V (dq)
  const int nt = (sk + ms::kTileRows - 1) / ms::kTileRows;
  auto prefetch = [&](int step) {
    if (step < 3 * nt) {
      const int t = step % nt;
      ms::stage_tile(ks[step & 1], kb, k_ss, t * ms::kTileRows, sk,
                     threadIdx.x, kBlockWarps * 32);
      ms::stage_bias(bs[step & 1], bias_b, t * ms::kTileRows, sk,
                     threadIdx.x, kBlockWarps * 32);
      if (step >= nt)
        ms::stage_tile(vs[step & 1], vb, v_ss, t * ms::kTileRows, sk,
                       threadIdx.x, kBlockWarps * 32);
    }
    ms::cp_async_commit();
  };

  ms::RowStats st;
  st.init();
  float rs[2] = {0.f, 0.f};  // partial rowsums, then each row's rowsum
  float acc[8][4];  // dq
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  prefetch(0);
  for (int step = 0; step < 3 * nt; ++step) {
    prefetch(step + 1);
    ms::cp_async_wait<1>();
    __syncthreads();
    const int pass = step / nt, t = step - pass * nt;
    if (live) {
#pragma unroll
      for (int ch = 0; ch < ms::kTileRows / ms::kChunk; ++ch) {
        const int j0 = t * ms::kTileRows + ch * ms::kChunk;
        if (j0 < sk) {
          float s[4][4];
          ms::mma_abt(s, qa, ks[step & 1], ch * ms::kChunk, lane);
          ms::finish_scores(s, bs[step & 1], ch * ms::kChunk, j0, sk,
                            scale, lane);
          if (pass == 0) {
            st.update(s);
          } else {
            float dp[4][4];
            ms::mma_abt(dp, ga, vs[step & 1], ch * ms::kChunk, lane);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const float p = ms::prob(s[n][e], st.m[r], st.l[r]);
                const float d = __fmul_rn(
                    dp[n][e],
                    ms::drop_at(key, (uint32_t)(row0 + gq + 8 * r),
                                (uint32_t)(j0 + n * 8 + 2 * c + (e & 1)),
                                threshold, keep_scale));
                if (pass == 1)
                  rs[r] = __fadd_rn(rs[r], __fmul_rn(d, p));
                else  // ds, rounded to bf16 by pack_a
                  s[n][e] = __fmul_rn(__fmul_rn(__fsub_rn(d, rs[r]), p),
                                      scale);
              }
            }
            if (pass == 2) {
              uint32_t da[2][4];
              ms::pack_a(da, s);
              ms::mma_ab(acc, da, ks[step & 1], ch * ms::kChunk, lane);
            }
          }
        }
      }
      if (step == nt - 1) st.finish();
      if (step == 2 * nt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] = ms::quad_sum(rs[r]);
          const int row = row0 + gq + 8 * r;
          if (c == 0 && row < sq) {
            float* sb = stats + ((int64_t)b * heads + h) * 3 * sq;
            sb[row] = st.m[r];
            sb[sq + row] = st.l[r];
            sb[2 * sq + row] = rs[r];
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next prefetch
  }
  if (live)
    ms::store_rows(dq + (int64_t)b * sq * heads * ms::kD + h * ms::kD,
                   (int64_t)heads * ms::kD, row0, sq, acc, lane);
}

template <int kBlockWarps>
__global__ void __launch_bounds__(kBlockWarps * 32)
    midseq_bwd_dkv_mma_kernel(const ms::bf16* __restrict__ q,
                              const ms::bf16* __restrict__ k,
                              const ms::bf16* __restrict__ v,
                              const float* __restrict__ bias,
                              const ms::bf16* __restrict__ g,
                              const float* __restrict__ stats,
                              ms::bf16* __restrict__ dk,
                              ms::bf16* __restrict__ dv, int sq, int sk,
                              int heads, int64_t q_sb, int64_t q_ss,
                              int64_t k_sb, int64_t k_ss, int64_t v_sb,
                              int64_t v_ss, int64_t g_sb, int64_t g_ss,
                              float scale, uint32_t seed, uint32_t batch0,
                              uint32_t head0, uint32_t threshold,
                              float keep_scale) {
  __shared__ __align__(128) ms::bf16 qs[2][ms::kTileElems];
  __shared__ __align__(128) ms::bf16 gs[2][ms::kTileElems];
  __shared__ float sts[2][3 * ms::kTileRows];  // max, denominator, rowsum

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = (blockIdx.x * kBlockWarps + warp) * 16;  // warp keys
  const bool live = key0 < sk;  // warp-uniform
  const ms::bf16* qb = q + b * q_sb + h * ms::kD;
  const ms::bf16* gb = g + b * g_sb + h * ms::kD;
  const float* stats_bh = stats + ((int64_t)b * heads + h) * 3 * sq;
  const uint32_t key = fa::keep_key(seed, (uint32_t)b + batch0,
      (uint32_t)h + head0);
  const int gk = lane >> 2, c = lane & 3;

  uint32_t ka[4][4], va[4][4];
  ms::load_a_rows(ka, k + b * k_sb + h * ms::kD, k_ss, key0, sk, lane);
  ms::load_a_rows(va, v + b * v_sb + h * ms::kD, v_ss, key0, sk, lane);
  float bj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + gk + 8 * r;
    bj[r] = j < sk ? __ldg(bias + (int64_t)b * sk + j) : 0.f;
  }

  const int mt = (sq + ms::kTileRows - 1) / ms::kTileRows;
  auto prefetch = [&](int step) {
    if (step < mt) {
      const int i0 = step * ms::kTileRows;
      ms::stage_tile(qs[step & 1], qb, q_ss, i0, sq, threadIdx.x,
                     kBlockWarps * 32);
      ms::stage_tile(gs[step & 1], gb, g_ss, i0, sq, threadIdx.x,
                     kBlockWarps * 32);
      for (int x = threadIdx.x; x < 3 * ms::kTileRows; x += kBlockWarps * 32) {
        const int which = x / ms::kTileRows, row = i0 + x % ms::kTileRows;
        const bool in = row < sq;
        ms::cp_async_4(&sts[step & 1][x],
                       stats_bh + (int64_t)which * sq + (in ? row : 0),
                       in ? 4 : 0);
      }
    }
    ms::cp_async_commit();
  };

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  prefetch(0);
  for (int step = 0; step < mt; ++step) {
    prefetch(step + 1);
    ms::cp_async_wait<1>();
    __syncthreads();
    const float* tile_st = sts[step & 1];
    if (live) {
#pragma unroll
      for (int ch = 0; ch < ms::kTileRows / ms::kChunk; ++ch) {
        const int i0 = step * ms::kTileRows + ch * ms::kChunk;
        if (i0 < sq) {
          float s[4][4], dp[4][4];  // transposed: rows keys, columns queries
          ms::mma_abt(s, ka, qs[step & 1], ch * ms::kChunk, lane);
          ms::mma_abt(dp, va, gs[step & 1], ch * ms::kChunk, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int col = ch * ms::kChunk + n * 8 + 2 * c + (e & 1);
              const int i = step * ms::kTileRows + col;
              float pt = 0.f, ds = 0.f;
              if (i < sq) {
                const float p = ms::prob(ms::score(s[n][e], scale, bj[r]),
                                         tile_st[col],
                                         tile_st[ms::kTileRows + col]);
                const float drop = ms::drop_at(
                    key, (uint32_t)i, (uint32_t)(key0 + gk + 8 * r),
                    threshold, keep_scale);
                pt = __fmul_rn(p, drop);
                ds = __fmul_rn(
                    __fmul_rn(__fsub_rn(__fmul_rn(dp[n][e], drop),
                                        tile_st[2 * ms::kTileRows + col]),
                              p),
                    scale);
              }
              s[n][e] = pt;
              dp[n][e] = ds;
            }
          }
          uint32_t pa[2][4], da[2][4];
          ms::pack_a(pa, s);
          ms::pack_a(da, dp);
          ms::mma_ab(dva, pa, gs[step & 1], ch * ms::kChunk, lane);
          ms::mma_ab(dka, da, qs[step & 1], ch * ms::kChunk, lane);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next prefetch
  }
  if (live) {
    const int64_t ld = (int64_t)heads * ms::kD;
    const int64_t o = (int64_t)b * sk * ld + h * ms::kD;
    ms::store_rows(dk + o, ld, key0, sk, dka, lane);
    ms::store_rows(dv + o, ld, key0, sk, dva, lane);
  }
}

int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, const void* g, void* dq, void* dk,
                void* dv, float* stats, int batch, int sq, int sk, int heads,
                int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                int64_t v_sb, int64_t v_ss, int64_t g_sb, int64_t g_ss,
                uint32_t seed, uint32_t batch0, uint32_t head0,
                    uint32_t threshold, float keep_scale,
                cudaStream_t stream) {
  if (!ms::aligned16(q, q_sb, q_ss) || !ms::aligned16(k, k_sb, k_ss) ||
      !ms::aligned16(v, v_sb, v_ss) || !ms::aligned16(g, g_sb, g_ss))
    return (int)cudaErrorMisalignedAddress;
  const float scale = 1.0f / sqrtf((float)ms::kD);
  const auto* qp = static_cast<const ms::bf16*>(q);
  const auto* kp = static_cast<const ms::bf16*>(k);
  const auto* vp = static_cast<const ms::bf16*>(v);
  const auto* gp = static_cast<const ms::bf16*>(g);
  auto* dqp = static_cast<ms::bf16*>(dq);
  auto* dkp = static_cast<ms::bf16*>(dk);
  auto* dvp = static_cast<ms::bf16*>(dv);
  cudaError_t err = ms::launch_by_width(
      sq, heads, batch,
      [&](dim3 grid) {
        midseq_bwd_dq_mma_kernel<4><<<grid, 128, 0, stream>>>(
            qp, kp, vp, bias, gp, dqp, stats, sq, sk, heads, q_sb, q_ss,
            k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale, seed, batch0, head0,
                threshold,
            keep_scale);
      },
      [&](dim3 grid) {
        midseq_bwd_dq_mma_kernel<1><<<grid, 32, 0, stream>>>(
            qp, kp, vp, bias, gp, dqp, stats, sq, sk, heads, q_sb, q_ss,
            k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale, seed, batch0, head0,
                threshold,
            keep_scale);
      });
  if (err != cudaSuccess) return (int)err;
  err = ms::launch_by_width(
      sk, heads, batch,
      [&](dim3 grid) {
        midseq_bwd_dkv_mma_kernel<4><<<grid, 128, 0, stream>>>(
            qp, kp, vp, bias, gp, stats, dkp, dvp, sq, sk, heads, q_sb, q_ss,
            k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale, seed, batch0, head0,
                threshold,
            keep_scale);
      },
      [&](dim3 grid) {
        midseq_bwd_dkv_mma_kernel<1><<<grid, 32, 0, stream>>>(
            qp, kp, vp, bias, gp, stats, dkp, dvp, sq, sk, heads, q_sb, q_ss,
            k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale, seed, batch0, head0,
                threshold,
            keep_scale);
      });
  return (int)err;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* g, void* dq, void* dk, void* dv, float* stats,
           int batch, int sq, int sk, int heads, int64_t q_sb, int64_t q_ss,
           int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss,
           int64_t g_sb, int64_t g_ss, uint32_t seed, uint32_t batch0,
           uint32_t head0, uint32_t threshold,
           float keep_scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(sk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto dq_kernel = midseq_bwd_dq_kernel<T>;
  // once per instantiation, at the first launch (not inside a CUDA graph
  // capture of a later one): allow up to the 227 KB a block may use
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const dim3 dq_grid((sq + kOwned - 1) / kOwned, heads, batch);
  dq_kernel<<<dq_grid, kWarps * 32, smem, stream>>>(
      qp, kp, vp, bias, gp, static_cast<T*>(dq), stats, sq, sk, heads, q_sb,
      q_ss, k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale, seed, batch0, head0,
          threshold,
      keep_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 dkv_grid((sk + kOwned - 1) / kOwned, heads, batch);
  midseq_bwd_dkv_kernel<T><<<dkv_grid, kWarps * 32, 0, stream>>>(
      qp, kp, vp, bias, gp, stats, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale,
      seed, batch0, head0, threshold, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns the first launch error (0
// when both were accepted). Pointers are device pointers; strides are in
// elements. `stats` is an fp32 scratch of batch * heads * 3 * sq floats.
// `is_bf16` selects bf16 (1) or fp32 (0) for q, k, v, g, dq, dk and dv.
// Dropout from `seed` (the int32 seed's bits), `threshold` =
// min(int(rate * 2^32), 2^32 - 1) and `keep_scale` = 1 / (1 - rate); rate 0
// is threshold 0, keep_scale 1. The keep mask is keyed on global batch row
// b + `batch0` and head h + `head0` (a data- or tensor-parallel rank's
// first row and head; 0 on one device).
int midseq_attention_bwd(const void* q, const void* k, const void* v,
                         const float* bias, const void* g, void* dq, void* dk,
                         void* dv, float* stats, int batch, int sq, int sk,
                         int heads, int head_dim, int64_t q_sb, int64_t q_ss,
                         int64_t k_sb, int64_t k_ss, int64_t v_sb,
                         int64_t v_ss, int64_t g_sb, int64_t g_ss,
                         int is_bf16, uint32_t seed, uint32_t batch0,
                         uint32_t head0, uint32_t threshold,
                         float keep_scale, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || sq < 1 ||
      sk < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, bias, g, dq, dk, dv, stats, batch, sq, sk,
                       heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, g_sb, g_ss,
                       seed, batch0, head0, threshold, keep_scale, s);
  return launch<float>(q, k, v, bias, g, dq, dk, dv, stats, batch, sq, sk,
                       heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, g_sb, g_ss,
                       seed, batch0, head0, threshold, keep_scale, s);
}

const char* midseq_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
