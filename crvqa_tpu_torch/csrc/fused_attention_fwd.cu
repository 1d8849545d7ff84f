// Fused short-sequence multi-head attention, forward, for NVIDIA Hopper
// (compiled for sm_90a; plain CUDA C++, no tensor-core instructions).
//
// Replaces the TPU kernel `crvqa_tpu/ops/fused_attention.py:_fwd_kernel` in
// both of its calls:
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
// What bounds it: memory. At LXMERT's shapes (Sq, Sk in {14, 36}, H = 12,
// D = 64) one call does ~18 FLOP per byte of q/k/v/out at (36, 36), far
// under the ~295 FLOP/byte at which an H100's tensor cores, and not its
// 3.35 TB/s of HBM, would limit. The TPU kernel's lane-blocked,
// block-diagonal formulation existed to feed a 128-lane matrix unit; here the
// arithmetic is too small to matter, so the design only has to read each
// input byte once and keep scores and probabilities on chip:
//
// - one block per (query-row tile of 8 rows, head, batch row); one warp per
//   query row;
// - K_h and then V_h are staged through shared memory in tiles of 32 keys,
//   converted to fp32, with a row pitch of D + 1 floats so that the lanes of
//   a warp, each on its own key, hit 32 different banks;
// - scores: lane j of a tile owns key j0 + j; the row's scores and then its
//   probabilities live in a per-warp shared-memory row of Sk floats;
// - softmax: per (row, head) max and sum by warp shuffles, the denominator
//   clamped at 1e-30 as the TPU kernel does (fused_attention.py:203);
// - context: each lane owns output columns lane and lane + 32 and walks the
//   staged V tile with p broadcast from shared memory.
//
// The forward for grad adds the fp32 residual write (4*B*Sq*H*Sk bytes,
// 16 MB at batch 256, (36, 36)), which dominates its traffic.
//
// At serving batch 32 a call moves 2.8-7.1 MB in bf16, 0.8-2.1 us of HBM
// time. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md) the
// kernel takes 10-38 us per call there, 7-18x that bound: the row-tile
// blocks of one (b, h) each re-stage K_h and V_h, a 36-key context stages
// two 32-key tiles, loads are 2-4 bytes wide, and each score reads both
// operands from shared memory. This design is the simple, correct first
// version; making it fast is later work.

#include "fused_attention_common.cuh"

namespace {

using fa::from_f32;
using fa::kHeadDim;
using fa::kMaxHeadsTimesSeq;
using fa::kPitch;
using fa::to_f32;

constexpr int kRows = 8;            // query rows (one warp each) per block
constexpr int kKeyTile = 32;        // keys per staged tile, one per lane

// Rows [j0, j0 + n) of one head's [S, D] slice -> tile[kKeyTile][kPitch] as
// fp32; tile rows at and past n are zeroed.
template <typename T>
__device__ __forceinline__ void stage_tile(float* tile, const T* src,
                                           int64_t row_stride, int j0, int n) {
  for (int i = threadIdx.x; i < kKeyTile * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    tile[r * kPitch + c] =
        r < n ? to_f32(src[(int64_t)(j0 + r) * row_stride + c]) : 0.f;
  }
}

// kTrain = false: the primal (no residual, no dropout). kTrain = true: the
// forward for grad; `p_out` may be null (the recompute backward keeps no
// residual), and rate 0 is threshold 0 with keep_scale 1 (every bit kept,
// p * 1 == p).
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kRows * 32)
    fused_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int sq, int sk, int heads,
                               int64_t q_sb, int64_t q_ss, int64_t k_sb,
                               int64_t k_ss, int64_t v_sb, int64_t v_ss,
                               float scale, float* __restrict__ p_out,
                               uint32_t seed, uint32_t threshold,
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

  const T* qb = q + b * q_sb + h * kHeadDim;
  const T* kb = k + b * k_sb + h * kHeadDim;
  const T* vb = v + b * v_sb + h * kHeadDim;
  const float* bias_b = bias + (int64_t)b * sk;
  const float* qrow = qs + warp * kHeadDim;
  float* p = probs + warp * sk;

  for (int i = threadIdx.x; i < kRows * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    qs[i] = row0 + r < sq ? to_f32(qb[(int64_t)(row0 + r) * q_ss + c]) : 0.f;
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
      const uint32_t key = fa::keep_key(seed, (uint32_t)b);
      float* res = p_out == nullptr
                       ? nullptr
                       : p_out + ((int64_t)b * sq + row) * heads * sk +
                             (int64_t)h * sk;
      for (int j = lane; j < sk; j += 32) {
        const float pf = p[j] / denom;
        if (res != nullptr) res[j] = pf;
        const bool keep = fa::keep_bit(key, (uint32_t)row,
                                       (uint32_t)(h * sk + j), threshold);
        p[j] = to_f32(from_f32<T>(keep ? pf * keep_scale : 0.f));
      }
    } else {
      for (int j = lane; j < sk; j += 32)
        p[j] = to_f32(from_f32<T>(p[j] / denom));
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
    T* o = out + ((int64_t)b * sq + row) * heads * kHeadDim + h * kHeadDim;
    o[lane] = from_f32<T>(acc0);
    o[lane + 32] = from_f32<T>(acc1);
  }
}

template <bool kTrain>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int batch, int sq, int sk, int heads, int head_dim,
           int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
           int64_t v_sb, int64_t v_ss, int is_bf16, float* p_out,
           uint32_t seed, uint32_t threshold, float keep_scale,
           void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || sq < 1 ||
      sk < 1 || heads < 1 || heads * sq > kMaxHeadsTimesSeq ||
      heads * sk > kMaxHeadsTimesSeq)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  const dim3 block(kRows * 32);
  const size_t smem = sizeof(float) * (kKeyTile * kPitch + kRows * kHeadDim +
                                       (size_t)kRows * sk);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_attention_fwd_kernel<__nv_bfloat16, kTrain><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias,
        static_cast<__nv_bfloat16*>(out), sq, sk, heads, q_sb, q_ss, k_sb,
        k_ss, v_sb, v_ss, scale, p_out, seed, threshold, keep_scale);
  } else {
    fused_attention_fwd_kernel<float, kTrain><<<grid, block, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), sq, sk,
        heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, p_out, seed,
        threshold, keep_scale);
  }
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
                       0u, 0u, 1.f, stream);
}

// The forward for grad: as above, plus the fp32 residual p_out
// [B, Sq, H*Sk] (contiguous; null to skip it) and dropout from `seed` (the
// int32 seed's bits), `threshold` and `keep_scale` = 1 / (1 - rate).
int fused_attention_fwd_train(const void* q, const void* k, const void* v,
                              const float* bias, void* out, float* p_out,
                              int batch, int sq, int sk, int heads,
                              int head_dim, int64_t q_sb, int64_t q_ss,
                              int64_t k_sb, int64_t k_ss, int64_t v_sb,
                              int64_t v_ss, int is_bf16, uint32_t seed,
                              uint32_t threshold, float keep_scale,
                              void* stream) {
  return launch<true>(q, k, v, bias, out, batch, sq, sk, heads, head_dim,
                      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, is_bf16, p_out,
                      seed, threshold, keep_scale, stream);
}

const char* fused_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
