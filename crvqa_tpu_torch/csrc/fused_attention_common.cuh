// Device helpers shared by the fused-attention forward and backward kernels
// (fused_attention_fwd.cu, fused_attention_bwd.cu) and the mid-length
// attention forward and backward (midseq_attention_fwd.cu,
// midseq_attention_bwd.cu). All include this file, so the
// recompute backward rebuilds exactly the probabilities the forward computed
// and stored, and the two attention kernels share one softmax and one
// dropout hash.
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

__device__ __forceinline__ bool keep_bit(uint32_t key, uint32_t i, uint32_t j,
                                         uint32_t threshold) {
  uint32_t x = i * 374761393u + j * 668265263u + key;
  x = x ^ (x >> 13);
  x = x * 1274126177u;
  x = x ^ (x >> 16);
  return x >= threshold;
}

}  // namespace fa
