// Masked matrix product y = x @ (w ⊙ [s > t]) and its straight-through
// backward, for NVIDIA Hopper (sm_90a): an operand pass, then the TMA +
// `wgmma` product of wgmma_gemm_common.cuh.
//
// Replaces the three TPU kernels of crvqa_tpu/ops/masked_matmul.py:
//
// - `_fwd_kernel` (:50, pallas_call :115) -> masked_matmul_fwd:
//     y[M, N] = bf16(x) @ bf16(w ⊙ m),  m = [scores > t]   (out: x's dtype)
// - `_dx_kernel` (:67, pallas_call :147) -> masked_matmul_dx:
//     dx[M, K] = bf16(g) @ bf16(w ⊙ m)ᵀ                     (out: x's dtype)
// - `_ds_kernel` (:86, pallas_call :176) -> masked_matmul_ds:
//     ds[K, N] = (bf16(x)ᵀ @ bf16(g)) ⊙ w, rounded to w's dtype, written
//     fp32 (the scores' dtype)
//
// The operand pass (`masked_operand_pass_kernel`) writes bf16 buffers with
// rows on 16-byte boundaries, which TMA reads:
// - mask mode: bf16(w ⊙ [s > t]) [K, N], once a call; the forward reads
//   it MN-major and dx K-major (wgmma's transpose bit), so one layout
//   serves both. The threshold is read from device memory and compared
//   against the fp32 scores in fp32 (masked_matmul.py:112-114), so a call
//   needs no host synchronisation and can be captured in a CUDA graph.
// - copy mode: bf16(x) or bf16(g) for an operand that TMA cannot read in
//   place (fp32, an inner stride other than 1, a row pitch or a start off
//   the 16-byte grid).
// Eight columns a thread: 16-byte loads where the source allows them.
//
// Why the mask is applied once, not in every tile: the TPU kernel fuses
// it into each tile and re-streams the fp32 weight and score tiles per row
// tile, which its module measured as 2x slower than materialising w ⊙ m
// (masked_matmul.py:19-31). At x [9216, 768] the packed weight costs one
// 3.5 MB read and a 1.2 MB write; the product then re-reads 1.2 MB per row
// tile from L2.
//
// What bounds it: at x [9216, 768] bf16, w [768, 768], fp32 scores a call
// does 10.9 GFLOP on 31.9 MB: 11.0 us at the bf16 tensor-core peak against
// 9.5 us of HBM time, so operations bound it, narrowly.
//
// ds sums over the M rows of x and g: its K x N output has few tiles (36
// at 768 x 768), so the wrapper splits the rows into `splits` ranges of
// `chunk` 64-row steps (its `ds_plan`) to fill the SMs. Each split writes
// fp32 partial sums, and `ds_split_reduce_kernel` adds them in split order
// and applies the STE factor: no atomics, the same bits on every call.
// (Adding the splits of a tile through distributed shared memory in a
// thread block cluster instead was slower on an H100: the card cannot
// hold the 36 clusters of 7 blocks at once, and smaller clusters leave
// SMs idle.)

#include <cstdio>

#include "wgmma_gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The operand pass (wg::operand_pass): mask mode when s is not null.
__global__ void masked_operand_pass_kernel(const void* src, int64_t rs,
                                           int64_t cs, int src_bf16,
                                           const float* s, const float* t,
                                           bf16* dst, int64_t ldd, int rows,
                                           int cols) {
  wg::operand_pass(src, rs, cs, src_bf16, s, t, dst, ldd, rows, cols);
}

// out[i] = round_e(sum_z part[z][i] * e[i]) over the m·n outputs, the
// splits added in order z = 0, 1, ...
__global__ void ds_split_reduce_kernel(const float* part, int splits,
                                       int64_t mn, const void* e, int e_bf16,
                                       float* out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < mn; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int z = 1; z < splits; ++z) v += part[z * mn + i];
    v *= wg::load_f32(e, i, e_bf16);
    out[i] = e_bf16 ? wg::bf16_round(v) : v;
  }
}

}  // namespace

extern "C" {

// The operand pass: dst [rows, ldd] bf16 (ldd a multiple of 8, dst 16-byte
// aligned) from src(r, c) at src[r * rs + c * cs] (bf16 if src_bf16, else
// fp32), masked by [s > *t] when s is not null (s with src's strides, t
// one fp32 value). Returns cudaGetLastError() after the launch.
int masked_matmul_operand_pass(const void* src, int64_t rs, int64_t cs,
                               int src_bf16, const float* s, const float* t,
                               void* dst, int64_t ldd, int rows, int cols,
                               void* stream) {
  if (rows < 1 || cols < 1 || ldd < cols || ldd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  masked_operand_pass_kernel<<<wg::grid_for(rows * (ldd / 8), 256), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      src, rs, cs, src_bf16, s, t, static_cast<bf16*>(dst), ldd, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// C[m, n] = A B over k with the TMA + wgmma product, both operands bf16
// with 16-byte aligned rows (pitches in elements). kind 0, the forward:
// A = x [m, k], B = w ⊙ m [k, n]; 1, dx: A = g [m, k], B stored [n, k]
// (w ⊙ m as it is); 2, ds: A stored [k, m] (x), B = g [k, n]. mode
// (wg::Mode): 0 C in bf16 (c_bf16) or fp32; 1 C fp32 = round_e(sum · e),
// e [m, n] with row pitch lde; 2 fp32 partial sums of split z at
// c + z·m·ldc. The reduction runs in `splits` ranges of `chunk` 64-deep
// steps. Returns 0 or an error code (masked_matmul_error_string).
int masked_matmul_product(int kind, const void* a, int64_t a_pitch,
                          const void* b, int64_t b_pitch, int m, int n, int k,
                          void* c, int64_t ldc, int mode, int c_bf16,
                          const void* e, int64_t lde, int e_bf16, int splits,
                          int chunk, void* stream) {
  wg::Epi p{};
  p.c = c, p.ldc = ldc, p.e = e, p.lde = lde;
  p.m = m, p.n = n, p.k = k;
  p.mode = mode, p.c_bf16 = c_bf16, p.e_bf16 = e_bf16, p.chunk = chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return wg::launch<false, true>(a, a_pitch, b, b_pitch, p, splits, st);
    case 1: return wg::launch<false, false>(a, a_pitch, b, b_pitch, p, splits, st);
    case 2: return wg::launch<true, true>(a, a_pitch, b, b_pitch, p, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the product kernel of `kind` one SM holds (-1 on an error).
int masked_matmul_blocks_per_sm(int kind) {
  switch (kind) {
    case 0: return wg::blocks_per_sm<false, true>();
    case 1: return wg::blocks_per_sm<false, false>();
    case 2: return wg::blocks_per_sm<true, true>();
    default: return -1;
  }
}

// ds[m·n] (fp32) = round_e(sum of `splits` partials [splits, m·n] · e), e
// contiguous, bf16 if e_bf16 else fp32.
int masked_matmul_ds_reduce(const float* part, int splits, int64_t mn,
                            const void* e, int e_bf16, float* out,
                            void* stream) {
  if (splits < 1 || mn < 1) return static_cast<int>(cudaErrorInvalidValue);
  ds_split_reduce_kernel<<<wg::grid_for(mn, 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      part, splits, mn, e, e_bf16, out);
  return static_cast<int>(cudaGetLastError());
}

const char* masked_matmul_error_string(int code) {
  static thread_local char buf[96];
  if (code >= wg::kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - wg::kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
