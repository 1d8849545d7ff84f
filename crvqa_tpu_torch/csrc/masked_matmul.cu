// Masked matrix product y = x @ (w ⊙ [s > t]) and its straight-through
// backward, for NVIDIA Hopper (compiled for sm_90a; bf16 tensor-core
// fragments through nvcuda::wmma, fp32 accumulators).
//
// Replaces the three TPU kernels of crvqa_tpu/ops/masked_matmul.py:
//
// - `_fwd_kernel` (:50, pallas_call :115) -> masked_matmul_fwd:
//     y[M, N] = bf16(x) @ bf16(w ⊙ m),  m = [scores > t]   (out: x's dtype)
// - `_dx_kernel` (:67, pallas_call :147) -> masked_matmul_dx:
//     dx[M, K] = bf16(g) @ bf16(w ⊙ m)ᵀ, the mask recomputed in the tile
//                                                           (out: x's dtype)
// - `_ds_kernel` (:86, pallas_call :176) -> masked_matmul_ds:
//     ds[K, N] = (bf16(x)ᵀ @ bf16(g)) ⊙ w, rounded to w's dtype, written
//     fp32 (the scores' dtype)
//
// The threshold is compared against the fp32 scores in fp32, never in w's
// dtype (masked_matmul.py:112-114); it is read from device memory, so a
// call needs no host synchronisation and can be captured in a CUDA graph.
// x, g and w are fp32 or bf16; every operand is rounded to bf16 as it is
// staged, as the TPU kernels round them (tile_gemm_common.cuh).
//
// What bounds it: at the shapes the JAX package measures ([9216, 768] x
// [768, 768], bf16 activations, fp32 scores) a call does 10.9 GFLOP on
// 31.9 MB: 11.0 us at the bf16 tensor-core peak against 9.5 us of HBM
// time, so operations bound it, narrowly. The TPU kernel's point was that the
// masked weight w ⊙ m is never written to device memory; here the mask is
// applied while the w tile is staged into shared memory, and for ds the
// STE factor w multiplies each sum in the epilogue, so (xᵀ g) never
// reaches device memory either. Each block re-reads its w and score tiles
// once per 64 rows of x (the TPU kernel re-streamed them per 256 rows);
// they stay in the 50 MB L2 at these sizes.
//
// Any M, K, N: the ragged edges are zero-filled in shared memory (the JAX
// version pads to 256-tiles instead).

#include "tile_gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// y and dx: A in the activation dtype TX, the masked B in w's dtype TW
template <typename TX, typename TW>
int masked(const tg::GemmArgs& p, void* stream) {
  return tg::launch<TX, TW, float, TX, TX, true, false, false>(p, stream);
}

template <typename TX, typename TG, typename TW>
int ds(const tg::GemmArgs& p, void* stream) {
  return tg::launch<TX, TG, TW, TW, float, false, true, false>(p, stream);
}

}  // namespace

extern "C" {

// y[M, N] (contiguous, x's dtype) = x[M, K] @ (w[K, N] ⊙ [s > *t]).
// x(i, kk) at x[i * x_rs + kk * x_cs]; w and s share the strides (w_rs,
// w_cs); t points to one fp32 value. `x_bf16` / `w_bf16` select bf16 (1) or
// fp32 (0). Returns cudaGetLastError() after the launch.
int masked_matmul_fwd(const void* x, int64_t x_rs, int64_t x_cs,
                      const void* w, const float* s, int64_t w_rs,
                      int64_t w_cs, const float* t, void* y, int m, int k,
                      int n, int x_bf16, int w_bf16, void* stream) {
  tg::GemmArgs p{};
  p.a = x, p.a_rs = x_rs, p.a_cs = x_cs;
  p.b = w, p.b_rs = w_rs, p.b_cs = w_cs, p.s = s, p.t = t;
  p.c = y, p.ldc = n, p.m = m, p.n = n, p.k = k;
  if (x_bf16)
    return w_bf16 ? masked<bf16, bf16>(p, stream)
                  : masked<bf16, float>(p, stream);
  return w_bf16 ? masked<float, bf16>(p, stream)
                : masked<float, float>(p, stream);
}

// dx[M, K] (contiguous, g's dtype, which is x's) = g[M, N] @ (w ⊙ [s > *t])ᵀ.
int masked_matmul_dx(const void* g, int64_t g_rs, int64_t g_cs,
                     const void* w, const float* s, int64_t w_rs,
                     int64_t w_cs, const float* t, void* dx_out, int m,
                     int k, int n, int g_bf16, int w_bf16, void* stream) {
  tg::GemmArgs p{};
  p.a = g, p.a_rs = g_rs, p.a_cs = g_cs;
  // B(kk = n, j = k) = w[k, n]: w read transposed in place
  p.b = w, p.b_rs = w_cs, p.b_cs = w_rs, p.s = s, p.t = t;
  p.c = dx_out, p.ldc = k, p.m = m, p.n = k, p.k = n;
  if (g_bf16)
    return w_bf16 ? masked<bf16, bf16>(p, stream)
                  : masked<bf16, float>(p, stream);
  return w_bf16 ? masked<float, bf16>(p, stream)
                : masked<float, float>(p, stream);
}

// ds[K, N] (contiguous fp32) = round_w((x[M, K]ᵀ @ g[M, N]) ⊙ w[K, N]).
int masked_matmul_ds(const void* x, int64_t x_rs, int64_t x_cs,
                     const void* g, int64_t g_rs, int64_t g_cs,
                     const void* w, int64_t w_rs, int64_t w_cs, float* ds_out,
                     int m, int k, int n, int x_bf16, int g_bf16, int w_bf16,
                     void* stream) {
  tg::GemmArgs p{};
  // A(i = k, kk = m) = x[m, k]: x read transposed in place
  p.a = x, p.a_rs = x_cs, p.a_cs = x_rs;
  p.b = g, p.b_rs = g_rs, p.b_cs = g_cs;
  p.e = w, p.e_rs = w_rs, p.e_cs = w_cs;
  p.c = ds_out, p.ldc = n, p.m = k, p.n = n, p.k = m;
  const int code = (x_bf16 << 2) | (g_bf16 << 1) | w_bf16;
  switch (code) {
    case 0: return ds<float, float, float>(p, stream);
    case 1: return ds<float, float, bf16>(p, stream);
    case 2: return ds<float, bf16, float>(p, stream);
    case 3: return ds<float, bf16, bf16>(p, stream);
    case 4: return ds<bf16, float, float>(p, stream);
    case 5: return ds<bf16, float, bf16>(p, stream);
    case 6: return ds<bf16, bf16, float>(p, stream);
    default: return ds<bf16, bf16, bf16>(p, stream);
  }
}

const char* masked_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
