// Head-compact matrix product for NVIDIA Hopper (compiled for sm_90a; bf16
// tensor-core fragments through nvcuda::wmma, fp32 accumulators):
//
//   y[M, H*64] = bf16(x[M, K]) @ bf16(w ⊙ head_mask),  w given as wt [N, K]
//
// computing only the kept heads' columns. Replaces the TPU kernel
// `crvqa_tpu/ops/structured_matmul.py:_kernel` (:119; pallas_call :177 in
// `head_compact_matmul_pallas` :137), which computes each kept head's
// [64, bm] block of wt[keep*64:(keep+1)*64, :] @ xᵀ, together with the
// XLA scatter after it (:184-186, mode="drop"): here each block writes its
// result straight into the dense output. Kept heads are keep[0..n_keep)
// (int32, device memory); pad entries carry the sentinel H, match no head
// and so write nothing, exactly what mode="drop" does with them (the TPU
// fetch clamps them to H - 1 and computes a block that is then dropped,
// :157). Every head that is not kept gets zero columns.
//
// Design: the tile product of tile_gemm_common.cuh with its column
// tile equal to one 64-wide head, so the block of column tile h computes
// head h if keep holds it and otherwise only writes zeros; wt is read in
// place transposed (B(kk, j) = wt[j, kk]). One launch writes the whole
// dense output, with no memset before it and no compute for dropped heads.
//
// What bounds it: at the shape the JAX package measures (x [9216, 768]
// bf16, 12 heads of 64 with 4 kept) a call reads x and the kept rows of wt
// and writes the dense [9216, 768] output, 28.7 MB (8.6 us at 3.35 TB/s),
// against 3.6 GFLOP (3.7 us at the bf16 tensor-core peak): bytes bound it.

#include "tile_gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename TX, typename TW>
int compact(const tg::GemmArgs& p, void* stream) {
  return tg::launch<TX, TW, TX>(p, stream);
}

}  // namespace

extern "C" {

// y[M, heads * 64] (contiguous, x's dtype) from x(i, kk) at
// x[i * x_rs + kk * x_cs] and wt(j, kk) at wt[j * wt_rs + kk * wt_cs];
// keep: n_keep int32 head indices in device memory. `x_bf16` / `wt_bf16`
// select bf16 (1) or fp32 (0). Returns cudaGetLastError() after the launch.
int head_compact_matmul(const void* x, int64_t x_rs, int64_t x_cs,
                        const void* wt, int64_t wt_rs, int64_t wt_cs,
                        const int* keep, int n_keep, void* y, int m, int k,
                        int heads, int x_bf16, int wt_bf16, void* stream) {
  if (heads < 1 || n_keep < 0) return (int)cudaErrorInvalidValue;
  tg::GemmArgs p{};
  p.a = x, p.a_rs = x_rs, p.a_cs = x_cs;
  p.b = wt, p.b_rs = wt_cs, p.b_cs = wt_rs;
  p.c = y, p.ldc = (int64_t)heads * tg::BN;
  p.m = m, p.n = heads * tg::BN, p.k = k;
  p.keep = keep, p.n_keep = n_keep;
  if (x_bf16)
    return wt_bf16 ? compact<bf16, bf16>(p, stream)
                   : compact<bf16, float>(p, stream);
  return wt_bf16 ? compact<float, bf16>(p, stream)
                 : compact<float, float>(p, stream);
}

const char* head_compact_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
