// Fused short-sequence multi-head attention, backward, for NVIDIA Hopper
// (compiled for sm_90a; plain CUDA C++, no tensor-core instructions).
//
// Replaces two TPU kernels of `crvqa_tpu/ops/fused_attention.py`, reached
// from `_fas_bwd` -> `_fa_bwd`:
//
// - `_bwd_kernel_stored` (the default, BWD_IMPL = "stored"): p is the
//   forward's fp32 residual [B, Sq, H*Sk] (fused_attention_fwd_train);
// - `_bwd_kernel` (BWD_IMPL = "recompute"): p is rebuilt from q, k and the
//   key bias with the forward's own softmax code (row_exp_sum in
//   fused_attention_common.cuh), so it equals the stored p bit for bit.
//
// Per batch row b and head h, with drop = keep ? 1 / (1 - rate) : 0 from
// the forward's counter-hash keep mask (regenerated, never stored):
//
//   p_t = p * drop;   dv = round_g(p_t)^T g
//   dp  = (g v^T) * drop
//   ds  = round_q((dp - rowsum(dp * p)) * p / sqrt(D))
//   dq  = ds k;       dk = ds^T q                      (fp32 accumulation)
//
// with the TPU kernel's rounding points (round_x: to x's dtype), which are
// what make bf16 agree. The key bias gets no gradient.
//
// What bounds it: memory. A call reads q, g, k, v (activation dtype) and,
// for the stored variant, the fp32 residual, and writes dq, dk, dv: at batch
// 256, (36, 36), bf16 about 115 MB against 8*B*H*Sq*Sk*D = 0.16 GFLOP, far
// under the H100's ~295 FLOP per HBM byte. The recompute variant reads the
// [B, Sk] bias instead of the residual and does 10*B*H*Sq*Sk*D FLOPs.
//
// Design (simple and correct first): one block of 256 threads per (head,
// batch row). It stages q_h, g_h, k_h, v_h ([S, 64] each, as fp32 with a row
// pitch of 65 floats so that threads on consecutive keys hit distinct
// banks) and the [Sq, Sk] p, dp/ds and p_t tiles in shared memory (53 KB at
// (36, 36)), then runs the five products as scalar fp32 FMAs, one output
// element per thread. Each input byte is read once from device memory.

#include "fused_attention_common.cuh"

namespace {

using fa::from_f32;
using fa::kHeadDim;
using fa::kMaxHeadsTimesSeq;
using fa::kPitch;
using fa::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper

size_t smem_bytes(int sq, int sk) {
  return sizeof(float) * ((size_t)(2 * sq + 2 * sk) * kPitch +
                          (size_t)3 * sq * sk);
}

// [S, D] head slice (row stride in elements) -> fp32 [S][kPitch]
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      int64_t row_stride, int rows) {
  for (int i = threadIdx.x; i < rows * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[r * kPitch + c] = to_f32(src[(int64_t)r * row_stride + c]);
  }
}

template <typename T, bool kStored>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ p_in,
        const float* __restrict__ bias, const T* __restrict__ g,
        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int sq,
        int sk, int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
        int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t g_sb,
        int64_t g_ss, float scale, uint32_t seed, uint32_t threshold,
        float keep_scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [sq][kPitch]
  float* gs = qs + sq * kPitch;  // [sq][kPitch]
  float* ks = gs + sq * kPitch;  // [sk][kPitch]
  float* vs = ks + sk * kPitch;  // [sk][kPitch]
  float* ps = vs + sk * kPitch;  // [sq][sk] pre-dropout p
  float* ds = ps + sq * sk;      // [sq][sk] dp, then ds (rounded)
  float* pt = ds + sq * sk;      // [sq][sk] p * drop, rounded to g's dtype

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int width = heads * kHeadDim;

  stage(qs, q + b * q_sb + h * kHeadDim, q_ss, sq);
  stage(gs, g + b * g_sb + h * kHeadDim, g_ss, sq);
  stage(ks, k + b * k_sb + h * kHeadDim, k_ss, sk);
  stage(vs, v + b * v_sb + h * kHeadDim, v_ss, sk);
  if (kStored) {
    for (int idx = tid; idx < sq * sk; idx += kThreads) {
      const int i = idx / sk, j = idx % sk;
      ps[idx] = p_in[((int64_t)b * sq + i) * heads * sk + (int64_t)h * sk + j];
    }
  }
  __syncthreads();

  if (!kStored) {
    // p from q, k and the bias, exactly as the forward computes it: lane j
    // of a warp on key j, an fma chain over the 64 columns, then the shared
    // row softmax
    const float* bias_b = bias + (int64_t)b * sk;
    for (int i = warp; i < sq; i += kWarps) {
      float* row = ps + i * sk;
      const float* qrow = qs + i * kPitch;
      for (int j = lane; j < sk; j += 32) {
        const float* krow = ks + j * kPitch;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kHeadDim; ++c) acc = fmaf(qrow[c], krow[c], acc);
        row[j] = acc * scale + bias_b[j];
      }
      __syncwarp();
      const float denom = fa::row_exp_sum(row, sk, lane);
      for (int j = lane; j < sk; j += 32) row[j] = row[j] / denom;
    }
    __syncthreads();
  }

  // dp = (g v^T) * drop and p_t = round_g(p * drop)
  const uint32_t key = fa::keep_key(seed, (uint32_t)b);
  for (int idx = tid; idx < sq * sk; idx += kThreads) {
    const int i = idx / sk, j = idx % sk;
    const float* grow = gs + i * kPitch;
    const float* vrow = vs + j * kPitch;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) acc = fmaf(grow[c], vrow[c], acc);
    const float drop =
        fa::keep_bit(key, (uint32_t)i, (uint32_t)(h * sk + j), threshold)
            ? keep_scale
            : 0.f;
    ds[idx] = acc * drop;
    pt[idx] = to_f32(from_f32<T>(ps[idx] * drop));
  }
  __syncthreads();

  // ds = round_q((dp - rowsum(dp * p)) * p * scale), one warp per row
  for (int i = warp; i < sq; i += kWarps) {
    float* dsrow = ds + i * sk;
    const float* prow = ps + i * sk;
    float sum = 0.f;
    for (int j = lane; j < sk; j += 32) sum += dsrow[j] * prow[j];
    sum = fa::warp_sum(sum);
    for (int j = lane; j < sk; j += 32)
      dsrow[j] = to_f32(from_f32<T>((dsrow[j] - sum) * prow[j] * scale));
  }
  __syncthreads();

  // dq = ds k: one (row, column) per thread
  for (int idx = tid; idx < sq * kHeadDim; idx += kThreads) {
    const int i = idx / kHeadDim, c = idx % kHeadDim;
    const float* dsrow = ds + i * sk;
    float acc = 0.f;
    for (int j = 0; j < sk; ++j) acc = fmaf(dsrow[j], ks[j * kPitch + c], acc);
    dq[((int64_t)b * sq + i) * width + h * kHeadDim + c] = from_f32<T>(acc);
  }
  // dk = ds^T q and dv = p_t^T g: one (key, column) per thread
  for (int idx = tid; idx < sk * kHeadDim; idx += kThreads) {
    const int j = idx / kHeadDim, c = idx % kHeadDim;
    float acck = 0.f, accv = 0.f;
    for (int i = 0; i < sq; ++i) {
      acck = fmaf(ds[i * sk + j], qs[i * kPitch + c], acck);
      accv = fmaf(pt[i * sk + j], gs[i * kPitch + c], accv);
    }
    const int64_t o = ((int64_t)b * sk + j) * width + h * kHeadDim + c;
    dk[o] = from_f32<T>(acck);
    dv[o] = from_f32<T>(accv);
  }
}

template <typename T, bool kStored>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* p_in, const float* bias, const void* g,
                 void* dq, void* dk, void* dv, int batch, int sq, int sk,
                 int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                 int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t g_sb,
                 int64_t g_ss, uint32_t seed, uint32_t threshold,
                 float keep_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(sq, sk);
  auto kernel = fused_attention_bwd_kernel<T, kStored>;
  // once per instantiation, at the first launch (not inside a CUDA graph
  // capture of a later one): allow up to the 227 KB a block may use
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  kernel<<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), p_in, bias, static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale, seed,
      threshold, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). `p_in` (stored: the forward's contiguous fp32
// residual [B, Sq, H*Sk]) or `bias` (recompute: contiguous fp32 [B, Sk])
// selects the variant: exactly one of them is non-null. q, k, v and g are
// read through batch and row strides (elements; last dimension
// contiguous); dq [B, Sq, H*D] and dk, dv [B, Sk, H*D] are contiguous.
// `seed`, `threshold` and `keep_scale` are the forward's dropout arguments.
int fused_attention_bwd(const void* q, const void* k, const void* v,
                        const float* p_in, const float* bias, const void* g,
                        void* dq, void* dk, void* dv, int batch, int sq,
                        int sk, int heads, int head_dim, int64_t q_sb,
                        int64_t q_ss, int64_t k_sb, int64_t k_ss,
                        int64_t v_sb, int64_t v_ss, int64_t g_sb,
                        int64_t g_ss, int is_bf16, uint32_t seed,
                        uint32_t threshold, float keep_scale, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || sq < 1 ||
      sk < 1 || heads < 1 || heads * sq > kMaxHeadsTimesSeq ||
      heads * sk > kMaxHeadsTimesSeq || (p_in == nullptr) == (bias == nullptr) ||
      smem_bytes(sq, sk) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stored = p_in != nullptr;
#define FA_BWD_ARGS                                                          \
  q, k, v, p_in, bias, g, dq, dk, dv, batch, sq, sk, heads, q_sb, q_ss,     \
      k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, seed, threshold, keep_scale, s
  if (is_bf16) {
    return stored ? launch_typed<__nv_bfloat16, true>(FA_BWD_ARGS)
                  : launch_typed<__nv_bfloat16, false>(FA_BWD_ARGS);
  }
  return stored ? launch_typed<float, true>(FA_BWD_ARGS)
                : launch_typed<float, false>(FA_BWD_ARGS);
#undef FA_BWD_ARGS
}

const char* fused_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
