// A tiled matrix product with bf16 tensor-core fragments and fp32
// accumulators, for the head-compact matmul kernel (head_compact_matmul.cu).
//
//   C[i, j] = sum_kk bf16(A[i, kk]) * bf16(B[kk, j])                (fp32)
//
// Operands are read in place through element strides, A(i, kk) at
// a[i * a_rs + kk * a_cs] and B(kk, j) at b[kk * b_rs + j * b_cs], so a
// transposed operand (the head-compact kernel's wt) is never copied. Each
// element is rounded to bf16 as it is staged into shared memory: the TPU
// kernel rounds every operand to bf16 before the MXU product
// (crvqa_tpu/ops/structured_matmul.py:129), so bf16 products with fp32
// sums are its definition, and a product of two bf16 values is exact in
// fp32.
//
// The head-compact mode: BN is the head width (64); the block of column
// tile h computes only if h is one of keep[0..n_keep), and otherwise
// writes zeros (the dropped columns of the dense output).
//
// Design: one block of 128 threads (4 warps) per 64 x 64 tile of C; each
// warp owns a 32 x 32 quarter (2 x 2 `nvcuda::wmma` 16x16x16 bf16
// fragments). The reduction runs in steps of 32: both tiles are staged into
// shared memory as bf16 (zero past the ragged edges, so any M, N, K is
// taken without padding), consecutive threads on the operand's contiguous
// dimension. The sums go through shared memory to the epilogue, which
// writes C row by row. Scalar loads and no overlap of loads with products:
// the simple first version; the masked matmul's TMA + `wgmma` product
// (wgmma_gemm_common.cuh) is what this moves onto next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tg {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;
constexpr int kPitchAB = BK + 8;  // bf16 row pitch of the A tile
constexpr int kPitchB = BN + 8;   // bf16 row pitch of the B tile
constexpr int kPitchC = BN + 4;   // fp32 row pitch of the C tile

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

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

struct GemmArgs {
  const void* a;
  int64_t a_rs, a_cs;  // A(i, kk)
  const void* b;
  int64_t b_rs, b_cs;  // B(kk, j)
  void* c;
  int64_t ldc;         // C(i, j) at c[i * ldc + j]
  int m, n, k;         // C is m x n; the sums run over k
  const int* keep;     // kept head indices (pads >= n / BN)
  int n_keep;
};

// Stage rows [r0, r0 + R) x cols [c0, c0 + C) of an operand into a bf16
// tile of pitch `pitch`, zero outside [0, rmax) x [0, cmax). Consecutive
// threads take consecutive columns when the operand is contiguous along
// its columns (cs == 1), else consecutive rows.
template <int R, int C, typename T>
__device__ __forceinline__ void stage(__nv_bfloat16* tile, int pitch,
                                      const T* src, int64_t rs, int64_t cs,
                                      int r0, int c0, int rmax, int cmax) {
  const bool col_fast = cs == 1;
  for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
    const int r = col_fast ? idx / C : idx % R;
    const int c = col_fast ? idx % C : idx / R;
    const int gr = r0 + r, gc = c0 + c;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (gr < rmax && gc < cmax) {
      const int64_t off = (int64_t)gr * rs + (int64_t)gc * cs;
      v = to_bf16(src[off]);
    }
    tile[r * pitch + c] = v;
  }
}

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
    tile_gemm_kernel(GemmArgs p) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * kPitchAB];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * kPitchB];
  __shared__ __align__(32) float Cs[BM * kPitchC];

  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  bool live = false;
  for (int h = 0; h < p.n_keep; ++h) live |= p.keep[h] == (int)blockIdx.x;
  if (!live) {  // a dropped head: its columns of C are zero
    TC* c = static_cast<TC*>(p.c);
    for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, col = idx % BN;
      if (i0 + r < p.m && j0 + col < p.n)
        c[(int64_t)(i0 + r) * p.ldc + j0 + col] = from_f32<TC>(0.f);
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int x = 0; x < 2; ++x)
    for (int y = 0; y < 2; ++y) wmma::fill_fragment(acc[x][y], 0.f);

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    stage<BM, BK, TA>(As, kPitchAB, static_cast<const TA*>(p.a), p.a_rs,
                      p.a_cs, i0, k0, p.m, p.k);
    stage<BK, BN, TB>(Bs, kPitchB, static_cast<const TB*>(p.b), p.b_rs,
                      p.b_cs, k0, j0, p.k, p.n);
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[2];
      for (int x = 0; x < 2; ++x)
        wmma::load_matrix_sync(af[x], As + (wr + 16 * x) * kPitchAB + kk,
                               kPitchAB);
      for (int y = 0; y < 2; ++y)
        wmma::load_matrix_sync(bf[y], Bs + kk * kPitchB + wc + 16 * y,
                               kPitchB);
      for (int x = 0; x < 2; ++x)
        for (int y = 0; y < 2; ++y)
          wmma::mma_sync(acc[x][y], af[x], bf[y], acc[x][y]);
    }
    __syncthreads();
  }

  for (int x = 0; x < 2; ++x)
    for (int y = 0; y < 2; ++y)
      wmma::store_matrix_sync(Cs + (wr + 16 * x) * kPitchC + wc + 16 * y,
                              acc[x][y], kPitchC, wmma::mem_row_major);
  __syncthreads();
  TC* c = static_cast<TC*>(p.c);
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, col = idx % BN;
    const int gi = i0 + r, gj = j0 + col;
    if (gi >= p.m || gj >= p.n) continue;
    c[(int64_t)gi * p.ldc + gj] = from_f32<TC>(Cs[r * kPitchC + col]);
  }
}

// Launches the kernel over ceil(m / BM) x ceil(n / BN) tiles on `stream`;
// returns cudaGetLastError().
template <typename TA, typename TB, typename TC>
int launch(const GemmArgs& p, void* stream) {
  const int64_t row_tiles = (p.m + BM - 1) / BM;
  if (p.m < 1 || p.n < 1 || p.k < 1 || row_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.n + BN - 1) / BN, (unsigned)row_tiles);
  tile_gemm_kernel<TA, TB, TC>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tg
