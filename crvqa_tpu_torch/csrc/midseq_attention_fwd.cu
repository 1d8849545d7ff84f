// Mid-length multi-head attention, forward, for NVIDIA Hopper (sm_90a):
// bf16 on the tensor cores (mma.sync), fp32 on scalar FMAs.
//
// Replaces the TPU kernel `crvqa_tpu/ops/midseq_attention.py:_fwd_kernel`
// (`midseq_attention_seeded` -> `_ms_primal` -> `pallas_call`): the
// attentions out of the short kernel's H*S <= 1024 scope that mPLUG runs,
// namely the CLIP ViT's (577, 577) self-attention, the fusion encoder's
// (25, 577) text->image cross-attention, the stride layer's (602, 602) joint
// self-attention, and the rank decoder's grouped (k*L, 602) cross-attention.
//
// Per batch row b and head h:
//
//   s[i, j]   = (q_h[i] . k_h[j]) / sqrt(D) + bias[b, j]          (fp32)
//   p[i, :]   = exp(s[i, :] - max) / sum(exp(s[i, :] - max))       (fp32)
//   p         = keep(b, h, i, j) ? p / (1 - rate) : 0    (only if rate > 0)
//   out_h[i]  = sum_j round_to_activation_dtype(p[i, j]) * v_h[j]  (fp32 acc)
//
// The softmax runs over the whole key row (not an online softmax that
// rescales the output), as the TPU kernel does: p is normalised before it
// is rounded for the context product. The TPU kernel's padded keys carried
// bias -1e30 and so probability exactly 0; here keys past Sk are masked in
// registers. The dropout keep bit is `_keep_mask(p.shape, rate, seed, b,
// h)`: keyed on the global batch row, the ABSOLUTE head index, the query
// row i and the plain key index j (fused_attention_common.cuh). q [B, Sq,
// H*D], k and v [B, Sk, H*D] are read in place through their batch and row
// strides (the ViT's q, k, v are column slices of one fused [B, S, 3*H*D]
// projection); the last dimension is contiguous. bias is [B, Sk] fp32. out
// is a contiguous [B, Sq, H*D] tensor in the activation dtype. D is 64.
//
// What bounds it on this card: arithmetic. The function does 4*B*H*Sq*Sk*D
// FLOPs (two products) against q, k, v read and out written once: at the
// ViT's (577, 577), batch 8, bf16, 8.2 GFLOP over 28 MB, 8.3 us at 989
// TFLOP/s against 8.5 us at 3.35 TB/s (chip_smoke.py `_bound_terms`).
//
// bf16 design (`midseq_fwd_mma_kernel`; midseq_mma_common.cuh):
//
// - one block per (64 query rows, head, batch row), 4 warps, each warp
//   owning 16 query rows; cross attentions with few query tiles (under 2
//   blocks per SM) take one-warp blocks of 16 rows instead, so (25, 577)
//   at batch 8 still gives 192 blocks;
// - q: each warp's rows go straight from global memory into the A operand
//   registers of mma.m16n8k16 (bf16 x bf16 -> fp32), once;
// - K and V: tiles of 64 keys staged by cp.async (16 bytes a thread, rows
//   zero-filled past Sk) into a ring of two stages, rows padded to 144
//   bytes so `ldmatrix` is free of bank conflicts; the next tile loads
//   while the current one computes;
// - two passes over the keys, scores in registers in the accumulator
//   layout: pass 1 forms S = Q K^T chunk by chunk (32 keys) and keeps each
//   row's running max and denominator (`ms::RowStats`, shared with the
//   backward's dq kernel, so both get the same bits); pass 2 forms S again,
//   p = exp(s - max) / denominator, the keep bit at each element's own (i,
//   j), rounds p to bf16 into A operands and accumulates P V on the tensor
//   cores (V through `ldmatrix.trans`). Q K^T is done twice: the price of a
//   full-row softmax whose [Sq, Sk] matrix does not fit a block (1.3 MB at
//   577 in fp32 against 227 KB);
// - the softmax's scalar work, not the tensor cores, sets the pace: exp is
//   2^(x log2 e) on the special-function unit and the division a product
//   with each row's reciprocal denominator (a few fp32 ulps from the plain
//   version's exp and division; p is still normalised before it is
//   rounded), and each tile's bias is staged beside its keys.
//
// fp32 stays on the scalar kernel below (`midseq_attention_fwd_kernel`):
// fp32 on the tensor cores is TF32, about three decimal digits, and the
// fp32 path is held to the plain version at 1e-5.
//
// fp32 design. One block per (16 query rows, head, batch row), 8 warps,
// each warp owning two adjacent query rows; K_h and then V_h staged
// through shared memory in tiles of 32 keys as fp32 (pitch D + 1); each
// row's scores, then probabilities, in a shared-memory row of Sk floats
// (16 x 602 keys: 38.5 KB; the 227 KB limit bounds Sk at about 3500, the
// wrapper checks); softmax with the short kernel's row code
// (`fa::row_exp_sum`); each lane owns output columns lane and lane + 32.

#include "midseq_mma_common.cuh"

namespace {

using fa::from_f32;
using fa::kHeadDim;
using fa::to_f32;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeyTile = 32;                  // keys per staged tile
constexpr int kPitch = kHeadDim + 1;          // staged row pitch in floats
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper

size_t smem_bytes(int sk) {
  return sizeof(float) *
         ((size_t)kKeyTile * kPitch + (size_t)kRows * kHeadDim +
          (size_t)kRows * sk);
}

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

// One query row's softmax and dropout, in place over its Sk scores, then
// the probabilities rounded to the activation dtype (as the TPU kernel
// rounds them before the context product).
template <typename T>
__device__ __forceinline__ void softmax_row(float* p, int sk, int lane,
                                            uint32_t key, uint32_t row,
                                            uint32_t threshold,
                                            float keep_scale) {
  const float denom = fa::row_exp_sum(p, sk, lane);
  for (int j = lane; j < sk; j += 32) {
    const float pf = p[j] / denom;
    const bool keep = fa::keep_bit(key, row, (uint32_t)j, threshold);
    p[j] = to_f32(from_f32<T>(keep ? pf * keep_scale : 0.f));
  }
}

// rate 0 is threshold 0 with keep_scale 1: every bit kept, p * 1 == p.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    midseq_attention_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int sq, int sk, int heads,
                                int64_t q_sb, int64_t q_ss, int64_t k_sb,
                                int64_t k_ss, int64_t v_sb, int64_t v_ss,
                                float scale, uint32_t seed, uint32_t batch0,
                                uint32_t head0, uint32_t threshold,
                                float keep_scale) {
  extern __shared__ float smem[];
  float* tile = smem;                     // [kKeyTile][kPitch]
  float* qs = tile + kKeyTile * kPitch;   // [kRows][D]
  float* probs = qs + kRows * kHeadDim;   // [kRows][sk]

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int r0 = warp * kRowsPerWarp;  // this warp's local rows r0, r0 + 1
  const int row_a = row0 + r0, row_b = row_a + 1;
  const bool live_a = row_a < sq, live_b = row_b < sq;  // warp-uniform

  const T* qb = q + b * q_sb + h * kHeadDim;
  const T* kb = k + b * k_sb + h * kHeadDim;
  const T* vb = v + b * v_sb + h * kHeadDim;
  const float* bias_b = bias + (int64_t)b * sk;
  const float* qa = qs + r0 * kHeadDim;
  const float* qb_row = qa + kHeadDim;
  float* pa = probs + (size_t)r0 * sk;
  float* pb = pa + sk;

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

  // softmax over each live row of this warp, fp32
  if (live_a) {
    __syncwarp();
    const uint32_t key = fa::keep_key(seed, (uint32_t)b + batch0,
        (uint32_t)h + head0);
    softmax_row<T>(pa, sk, lane, key, (uint32_t)row_a, threshold,
                   keep_scale);
    if (live_b)
      softmax_row<T>(pb, sk, lane, key, (uint32_t)row_b, threshold,
                     keep_scale);
    __syncwarp();
  }

  // context: lane owns output columns lane and lane + 32 of both rows
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
  for (int j0 = 0; j0 < sk; j0 += kKeyTile) {
    const int n = min(kKeyTile, sk - j0);
    __syncthreads();
    stage_tile(tile, vb, v_ss, j0, n);
    __syncthreads();
    if (live_a) {
      const float* prow_a = pa + j0;
      const float* prow_b = pb + j0;
      for (int r = 0; r < n; ++r) {
        const float v0 = tile[r * kPitch + lane];
        const float v1 = tile[r * kPitch + lane + 32];
        const float wa = prow_a[r];
        a0 = fmaf(wa, v0, a0);
        a1 = fmaf(wa, v1, a1);
        if (live_b) {
          const float wb = prow_b[r];
          b0 = fmaf(wb, v0, b0);
          b1 = fmaf(wb, v1, b1);
        }
      }
    }
  }
  const int64_t ld = (int64_t)heads * kHeadDim;
  if (live_a) {
    T* o = out + ((int64_t)b * sq + row_a) * ld + h * kHeadDim;
    o[lane] = from_f32<T>(a0);
    o[lane + 32] = from_f32<T>(a1);
  }
  if (live_b) {
    T* o = out + ((int64_t)b * sq + row_b) * ld + h * kHeadDim;
    o[lane] = from_f32<T>(b0);
    o[lane + 32] = from_f32<T>(b1);
  }
}


// ------------------------------------------------------- bf16, tensor cores

template <int kBlockWarps>
__global__ void __launch_bounds__(kBlockWarps * 32)
    midseq_fwd_mma_kernel(const ms::bf16* __restrict__ q,
                          const ms::bf16* __restrict__ k,
                          const ms::bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          ms::bf16* __restrict__ out, int sq, int sk,
                          int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                          int64_t k_ss, int64_t v_sb, int64_t v_ss,
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

  uint32_t qa[4][4];
  ms::load_a_rows(qa, q + b * q_sb + h * ms::kD, q_ss, row0, sq, lane);

  // steps [0, nt): pass 1 over K tiles; [nt, 2 nt): pass 2 over K and V
  const int nt = (sk + ms::kTileRows - 1) / ms::kTileRows;
  auto prefetch = [&](int step) {
    if (step < 2 * nt) {
      const int t = step < nt ? step : step - nt;
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
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int g = lane >> 2, c = lane & 3;

  prefetch(0);
  for (int step = 0; step < 2 * nt; ++step) {
    prefetch(step + 1);
    ms::cp_async_wait<1>();
    __syncthreads();
    const bool second = step >= nt;
    const int t = second ? step - nt : step;
    if (live) {
#pragma unroll
      for (int ch = 0; ch < ms::kTileRows / ms::kChunk; ++ch) {
        const int j0 = t * ms::kTileRows + ch * ms::kChunk;
        if (j0 < sk) {
          float s[4][4];
          ms::mma_abt(s, qa, ks[step & 1], ch * ms::kChunk, lane);
          ms::finish_scores(s, bs[step & 1], ch * ms::kChunk, j0, sk,
                            scale, lane);
          if (!second) {
            st.update(s);
          } else {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                s[n][e] = __fmul_rn(
                    ms::prob(s[n][e], st.m[r], st.l[r]),
                    ms::drop_at(key, (uint32_t)(row0 + g + 8 * r),
                                (uint32_t)(j0 + n * 8 + 2 * c + (e & 1)),
                                threshold, keep_scale));
              }
            }
            uint32_t pa[2][4];
            ms::pack_a(pa, s);
            ms::mma_ab(o, pa, vs[step & 1], ch * ms::kChunk, lane);
          }
        }
      }
      if (step == nt - 1) st.finish();
    }
    __syncthreads();  // the stage is refilled by the next prefetch
  }
  if (live)
    ms::store_rows(out + (int64_t)b * sq * heads * ms::kD + h * ms::kD,
                   (int64_t)heads * ms::kD, row0, sq, o, lane);
}

int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, void* out, int batch, int sq, int sk,
                int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                int64_t k_ss, int64_t v_sb, int64_t v_ss, uint32_t seed,
                uint32_t batch0, uint32_t head0, uint32_t threshold,
                float keep_scale, cudaStream_t stream) {
  if (!ms::aligned16(q, q_sb, q_ss) || !ms::aligned16(k, k_sb, k_ss) ||
      !ms::aligned16(v, v_sb, v_ss))
    return (int)cudaErrorMisalignedAddress;
  const float scale = 1.0f / sqrtf((float)ms::kD);
  const auto* qp = static_cast<const ms::bf16*>(q);
  const auto* kp = static_cast<const ms::bf16*>(k);
  const auto* vp = static_cast<const ms::bf16*>(v);
  auto* op = static_cast<ms::bf16*>(out);
  return (int)ms::launch_by_width(
      sq, heads, batch,
      [&](dim3 grid) {
        midseq_fwd_mma_kernel<4><<<grid, 128, 0, stream>>>(
            qp, kp, vp, bias, op, sq, sk, heads, q_sb, q_ss, k_sb, k_ss,
            v_sb, v_ss, scale, seed, batch0, head0, threshold, keep_scale);
      },
      [&](dim3 grid) {
        midseq_fwd_mma_kernel<1><<<grid, 32, 0, stream>>>(
            qp, kp, vp, bias, op, sq, sk, heads, q_sb, q_ss, k_sb, k_ss,
            v_sb, v_ss, scale, seed, batch0, head0, threshold, keep_scale);
      });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int batch, int sq, int sk, int heads, int64_t q_sb,
           int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb,
           int64_t v_ss, uint32_t seed, uint32_t batch0, uint32_t head0,
               uint32_t threshold, float keep_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(sk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = midseq_attention_fwd_kernel<T>;
  // once per instantiation, at the first launch (not inside a CUDA graph
  // capture of a later one): allow up to the 227 KB a block may use
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), sq, sk, heads,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, seed, batch0, head0, threshold,
      keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). Pointers are device pointers; strides are in
// elements. `is_bf16` selects bf16 (1) or fp32 (0) for q, k, v and out.
// Dropout from `seed` (the int32 seed's bits), `threshold` =
// min(int(rate * 2^32), 2^32 - 1) and `keep_scale` = 1 / (1 - rate); rate 0
// is threshold 0, keep_scale 1. The keep mask is keyed on global batch row
// b + `batch0` and head h + `head0` (a data- or tensor-parallel rank's
// first row and head; 0 on one device).
int midseq_attention_fwd(const void* q, const void* k, const void* v,
                         const float* bias, void* out, int batch, int sq,
                         int sk, int heads, int head_dim, int64_t q_sb,
                         int64_t q_ss, int64_t k_sb, int64_t k_ss,
                         int64_t v_sb, int64_t v_ss, int is_bf16,
                         uint32_t seed, uint32_t batch0, uint32_t head0,
                             uint32_t threshold, float keep_scale,
                         void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || sq < 1 ||
      sk < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, bias, out, batch, sq, sk, heads, q_sb, q_ss,
                       k_sb, k_ss, v_sb, v_ss, seed, batch0, head0, threshold,
                           keep_scale,
                       s);
  return launch<float>(q, k, v, bias, out, batch, sq, sk, heads, q_sb, q_ss,
                       k_sb, k_ss, v_sb, v_ss, seed, batch0, head0, threshold,
                           keep_scale,
                       s);
}

const char* midseq_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
