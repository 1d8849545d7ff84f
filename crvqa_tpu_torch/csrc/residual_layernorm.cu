// The epilogue of every transformer output block, LayerNorm(dropout(y) +
// residual), and its backward, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the epilogue as flax ops
// (crvqa_tpu/models/layers.py `AttentionOutput` :343, `LxmertOutput`) and
// XLA fuses them. Eager PyTorch ran it as about 13 launches a site (the
// keep test, the scale, the select, the add, two casts, the LayerNorm and
// their backwards), moving about 40 bytes an element forward and 33
// backward in bf16 (the fp32 uniform draw aside).
//
// Forward, one warp a row of `width` columns, 4 columns a lane a step:
//   keep = r < keep_prob                              (r: the fp32 draw)
//   a    = keep ? T(y * inv_keep) : 0                  (T: the activation
//   z    = T(a + residual)                              dtype, rounded RNE)
//   out  = T((z - mean) * rstd * gamma + beta),  mean and rstd of z in fp32
// writing out and, for the backward, z, keep (a byte an element) and the
// row's mean and rstd. The rounding points are eager PyTorch's on CUDA:
// `y / keep_prob` by a CPU scalar multiplies by the fp32 reciprocal
// (inv_keep, computed by the caller; `__fmul_rn`, so that no FMA merges
// it into the add), and the add rounds to T. Without r
// (rate 0) a = y; without z (no gradient wanted) only out is written.
//
// Backward, one warp a row: with g the incoming gradient, xh = (z - mean) *
// rstd and gg = g * gamma, as PyTorch's LayerNorm backward,
//   dz = T(rstd / W * (W * gg - sum(gg) - xh * sum(gg * xh)))
//   dy = keep ? T(dz * inv_keep) : 0
// dz is the residual's gradient, dy the dense output's. When gamma and beta
// take gradients each block also sums g * xh and g over its rows into one
// partial row each, and `residual_layernorm_param_reduce_kernel` adds the
// partial rows in a fixed order: no atomics, the same bits on every call.
//
// What bounds it: bytes. At LXMERT's visual site (2048 x 36 rows of 768,
// bf16, rate 0.1) the forward reads y, the residual and r (8 bytes an
// element) and writes out, z and keep (5): 0.74 GB, 0.22 ms at 3.35 TB/s;
// the backward reads g, z and keep (5) and writes dz and dy (4): 0.51 GB,
// 0.15 ms. Design: a row is one warp, so the statistics are two warp
// shuffles and nothing crosses a block; every lane keeps its 24 values in
// registers between the statistics and the output, so each byte is read
// once; loads are 8 (bf16) or 16 (fp32, r) bytes a lane and neighbouring
// lanes read neighbouring addresses. Blocks of 8 warps walk the rows with
// a stride of the grid, which the caller sizes (at most 1056 blocks, eight
// an SM).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // rows a block works on at a time
constexpr int kThreads = 32 * kWarps;

// Four consecutive elements of T as fp32, and T's rounding.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float v[4]) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<uint32_t*>(&lo) = t.x;
    *reinterpret_cast<uint32_t*>(&hi) = t.y;
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float v[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<uint32_t*>(&lo);
    t.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The butterfly leaves the same bits in every lane (each step adds the
// same two values, in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Columns of lane `lane` at step c: 4 from (c * 32 + lane) * 4.
__device__ __forceinline__ int column(int c, int lane) {
  return (c * 32 + lane) * 4;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    residual_layernorm_fwd_kernel(const T* __restrict__ y,
                                  const T* __restrict__ res,
                                  const float* __restrict__ r,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  T* __restrict__ out, T* __restrict__ z,
                                  uint8_t* __restrict__ keep,
                                  float* __restrict__ mean,
                                  float* __restrict__ rstd, int64_t rows,
                                  float keep_prob, float inv_keep,
                                  float eps) {
  constexpr int W = 128 * C;
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * kWarps;
  for (int64_t row = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
       row < rows; row += stride) {
    const int64_t base = row * W;
    float v[C][4];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t i = base + column(c, lane);
      float a[4], b[4];
      Io<T>::load(y + i, a);
      Io<T>::load(res + i, b);
      if (r != nullptr) {
        const float4 u = __ldcs(reinterpret_cast<const float4*>(r + i));
        const bool k[4] = {u.x < keep_prob, u.y < keep_prob,
                           u.z < keep_prob, u.w < keep_prob};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = k[e] ? Io<T>::round(__fmul_rn(a[e], inv_keep)) : 0.f;
        if (keep != nullptr)
          *reinterpret_cast<uchar4*>(keep + i) =
              make_uchar4(k[0], k[1], k[2], k[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[c][e] = Io<T>::round(a[e] + b[e]);
        sum += v[c][e];
      }
      if (z != nullptr) Io<T>::store(z + i, v[c]);
    }
    const float mu = warp_sum(sum) / float(W);
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[c][e] - mu;
        sq += d * d;
      }
    const float rs = rsqrtf(warp_sum(sq) / float(W) + eps);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = column(c, lane);
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(gamma + col));
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(beta + col));
      const float gm[4] = {g4.x, g4.y, g4.z, g4.w};
      const float bt[4] = {b4.x, b4.y, b4.z, b4.w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = (v[c][e] - mu) * rs * gm[e] + bt[e];
      Io<T>::store(out + base + col, o);
    }
    if (mean != nullptr && lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// kParams: also the per-block partial sums of g * xh (part) and g (part +
// gridDim.x * W), one row each.
template <typename T, int C, bool kParams>
__global__ void __launch_bounds__(kThreads)
    residual_layernorm_bwd_kernel(const T* __restrict__ g,
                                  const T* __restrict__ z,
                                  const uint8_t* __restrict__ keep,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ rstd,
                                  const float* __restrict__ gamma,
                                  T* __restrict__ dz, T* __restrict__ dy,
                                  float* __restrict__ part, int64_t rows,
                                  float inv_keep) {
  constexpr int W = 128 * C;
  __shared__ float red[kParams ? kWarps * W : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  float acc_g[kParams ? C : 1][4] = {};
  float acc_b[kParams ? C : 1][4] = {};
  const int64_t stride = int64_t(gridDim.x) * kWarps;
  for (int64_t row = int64_t(blockIdx.x) * kWarps + warp; row < rows;
       row += stride) {
    const int64_t base = row * W;
    const float mu = mean[row], rs = rstd[row];
    float gg[C][4], xh[C][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = column(c, lane);
      float gv[4], zv[4];
      Io<T>::load(g + base + col, gv);
      Io<T>::load(z + base + col, zv);
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(gamma + col));
      const float gm[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xh[c][e] = (zv[e] - mu) * rs;
        gg[c][e] = gv[e] * gm[e];
        s1 += gg[c][e];
        s2 += gg[c][e] * xh[c][e];
        if constexpr (kParams) {
          acc_g[c][e] += gv[e] * xh[c][e];
          acc_b[c][e] += gv[e];
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float term = rs / float(W);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t i = base + column(c, lane);
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = Io<T>::round((float(W) * gg[c][e] - s1 - xh[c][e] * s2) * term);
      if (dz != nullptr) Io<T>::store(dz + i, d);
      if (dy != nullptr) {
        if (keep != nullptr) {
          const uchar4 k = *reinterpret_cast<const uchar4*>(keep + i);
          const bool kk[4] = {k.x != 0, k.y != 0, k.z != 0, k.w != 0};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = kk[e] ? Io<T>::round(__fmul_rn(d[e], inv_keep)) : 0.f;
        }
        Io<T>::store(dy + i, d);
      }
    }
  }
  if constexpr (kParams) {
    // The block's warps in order, then one partial row per block.
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[warp * W + column(c, lane) + e] =
              pass == 0 ? acc_g[c][e] : acc_b[c][e];
      __syncthreads();
      float* dst = part + (int64_t(pass) * gridDim.x + blockIdx.x) * W;
      for (int col = threadIdx.x; col < W; col += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w * W + col];
        dst[col] = s;
      }
      __syncthreads();
    }
  }
}

// dgamma / dbeta [width] from the partial rows part[2][blocks][width]: 32
// columns a block, 8 slices each summing the partial rows congruent to it
// mod 8 in order, then the slices in order.
__global__ void residual_layernorm_param_reduce_kernel(
    const float* __restrict__ part, int blocks, int width,
    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float s[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + int64_t(blockIdx.y) * blocks * width;
  float acc = 0.f;
  if (col < width)
    for (int b = threadIdx.y; b < blocks; b += 8)
      acc += p[int64_t(b) * width + col];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += s[k][threadIdx.x];
    (blockIdx.y == 0 ? dgamma : dbeta)[col] = t;
  }
}

template <typename T, int C>
int launch_fwd(const void* y, const void* res, const float* r,
               const float* gamma, const float* beta, void* out, void* z,
               uint8_t* keep, float* mean, float* rstd, int64_t rows,
               float keep_prob, float inv_keep, float eps, int blocks,
               cudaStream_t stream) {
  residual_layernorm_fwd_kernel<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(res), r, gamma, beta,
      static_cast<T*>(out), static_cast<T*>(z), keep, mean, rstd, rows,
      keep_prob, inv_keep, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_bwd(const void* g, const void* z, const uint8_t* keep,
               const float* mean, const float* rstd, const float* gamma,
               void* dz, void* dy, float* part, float* dgamma, float* dbeta,
               int64_t rows, float inv_keep, int blocks,
               cudaStream_t stream) {
  if (part == nullptr) {
    residual_layernorm_bwd_kernel<T, C, false><<<blocks, kThreads, 0,
                                                 stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(z), keep, mean, rstd,
        gamma, static_cast<T*>(dz), static_cast<T*>(dy), nullptr, rows,
        inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
  residual_layernorm_bwd_kernel<T, C, true><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(z), keep, mean, rstd,
      gamma, static_cast<T*>(dz), static_cast<T*>(dy), part, rows, inv_keep);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  constexpr int W = 128 * C;
  residual_layernorm_param_reduce_kernel<<<dim3((W + 31) / 32, 2),
                                           dim3(32, 8), 0, stream>>>(
      part, blocks, W, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [rows, width] = LayerNorm(dropout(y) + res) (header). y, res, out, z
// contiguous in T (bf16 if is_bf16, else fp32), 16-byte aligned; r (fp32
// draw), keep, z, mean and rstd may be null (no dropout; nothing saved);
// gamma, beta fp32 [width]. The width must be one the kernels were built
// for (768). Returns cudaGetLastError() after the launch.
int residual_layernorm_fwd(const void* y, const void* res, const float* r,
                           const float* gamma, const float* beta, void* out,
                           void* z, uint8_t* keep, float* mean, float* rstd,
                           int64_t rows, int width, int is_bf16,
                           float keep_prob, float inv_keep, float eps,
                           int blocks, void* stream) {
  if (rows < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 768:
      return is_bf16 ? launch_fwd<bf16, 6>(y, res, r, gamma, beta, out, z,
                                           keep, mean, rstd, rows, keep_prob,
                                           inv_keep, eps, blocks, s)
                     : launch_fwd<float, 6>(y, res, r, gamma, beta, out, z,
                                            keep, mean, rstd, rows,
                                            keep_prob, inv_keep, eps, blocks,
                                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dz and dy (either may be null) from the incoming gradient g and what the
// forward saved; keep null: dy = dz unscaled. With part (fp32
// [2, blocks, width] scratch) also dgamma and dbeta, fp32 [width].
int residual_layernorm_bwd(const void* g, const void* z, const uint8_t* keep,
                           const float* mean, const float* rstd,
                           const float* gamma, void* dz, void* dy, float* part,
                           float* dgamma, float* dbeta, int64_t rows,
                           int width, int is_bf16, float inv_keep, int blocks,
                           void* stream) {
  if (rows < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 768:
      return is_bf16 ? launch_bwd<bf16, 6>(g, z, keep, mean, rstd, gamma, dz,
                                           dy, part, dgamma, dbeta, rows,
                                           inv_keep, blocks, s)
                     : launch_bwd<float, 6>(g, z, keep, mean, rstd, gamma, dz,
                                            dy, part, dgamma, dbeta, rows,
                                            inv_keep, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* residual_layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
