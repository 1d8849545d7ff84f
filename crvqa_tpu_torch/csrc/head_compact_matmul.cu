// Head-compact matrix product for NVIDIA Hopper (sm_90a), on the TMA +
// `wgmma` product of wgmma_gemm_common.cuh:
//
//   y[M, H*64] = bf16(x[M, K]) @ bf16(w ⊙ head_mask),  w given as wt [N, K]
//
// computing only the kept heads' columns. Replaces the TPU kernel
// `crvqa_tpu/ops/structured_matmul.py:_kernel` (:119; pallas_call :177 in
// `head_compact_matmul_pallas` :137), which computes each kept head's
// [64, bm] block of wt[keep*64:(keep+1)*64, :] @ xᵀ, together with the
// XLA scatter after it (:184-186, mode="drop"): here each block writes its
// result straight into the dense output. Kept heads are keep[0..n_keep)
// (int32, device memory); an entry outside [0, H) (the pad sentinel H)
// writes nothing, exactly what mode="drop" does with it (the TPU fetch
// clamps it to H - 1 and computes a block that is then dropped, :157).
// Every head that is not kept gets zero columns.
//
// Design, one launch of a 1-D grid:
// - Product blocks first: for each row tile of 128 rows, one per pair of
//   keep slots (2t, 2t + 1), running the core's 128 x 128 tile in head
//   mode. A is x [M, K], B is wt [N, K], both K-major; B's two 64-row
//   atoms are the two slots' heads, rows keep[2t] * 64 and keep[2t + 1] *
//   64 of wt, two 64 x 64 TMA boxes a stage. The epilogue writes the two
//   column halves into those heads' columns of y. A pad slot is neither
//   loaded nor written (its half of the products runs on whatever the
//   ring holds and is dropped), and the stage's barrier expects only the
//   bytes loaded; a pair of two pads exits at once.
// - Then the zero blocks, one per 64 rows: every column of those rows
//   that belongs to a head not in keep gets 0, 16 bytes a thread. So one
//   launch writes the whole dense output, with no memset and no products
//   for dropped heads. The zero blocks fill the block slots the product
//   blocks leave, and take over the slots they free.
// - keep is read only on the device and the tensor maps are encoded for
//   each launch, so a call needs no host synchronisation and can be
//   captured in a CUDA graph; no atomics, so the output's bits repeat.
// - Operands TMA cannot read in place (fp32, strided or misaligned) are
//   first rounded into bf16 buffers by `head_compact_operand_pass_kernel`
//   (wg::operand_pass in copy mode). That is exact: the TPU kernel rounds
//   both operands to bf16 before the product (:129).
//
// What bounds it: at the shape the JAX package measures (x [9216, 768]
// bf16, 12 heads of 64 with 4 kept) a call reads x and the kept rows of wt
// and writes the dense [9216, 768] output, 28.7 MB (8.6 us at 3.35 TB/s),
// against 3.6 GFLOP (3.7 us at the bf16 tensor-core peak): bytes bound it.
// The zeros are 9.4 of the 14.2 MB written. The 144 product blocks (72
// row tiles x 2 pairs) take the 132 SMs and 12 second slots, and draw 57
// MB from L2 (x once per pair, the kept rows of wt once per row tile).
//
// Tried on an H100 at that shape and left out:
// - one head a product block (emulated by pairing each kept head with a
//   pad; chip_smoke.py's phase head-compact-kernel times it as
//   `kept4_split_pairs`): x is read once per head;
// - a zero block after each row tile's product blocks, or every zero
//   block first: slower than product blocks first at 6 of 12 heads kept,
//   where product and zero blocks take more than one wave;
// - zero blocks of 128 rows: slower when few heads are kept and the
//   zeros are most of the work.

#include <cstdio>

#include "wgmma_gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The most heads a call takes: a zero block keeps a flag and an index per
// head in the ring's shared memory.
constexpr int kMaxHeads = 16384;
constexpr int kZeroRows = 64;  // rows of C a zero block covers
static_assert(kMaxHeads * 5 + 4 <= wg::kSmemBytes, "head lists fit");

__global__ void head_compact_operand_pass_kernel(const void* src, int64_t rs,
                                                 int64_t cs, int src_bf16,
                                                 bf16* dst, int64_t ldd,
                                                 int rows, int cols) {
  wg::operand_pass(src, rs, cs, src_bf16, nullptr, nullptr, dst, ldd, rows,
                   cols);
}

// The first row (= C column) of keep slot s's head, or -1 where the slot
// is past n_keep or holds no head in [0, heads).
__device__ __forceinline__ int head_start(const int* keep, int s, int n_keep,
                                          int heads) {
  if (s >= n_keep) return -1;
  const int h = keep[s];
  return h >= 0 && h < heads ? h * 64 : -1;
}

// Zeros in every column of rows [m0, m0 + kZeroRows) of C whose head is
// not in keep[0..n_keep), 16 bytes a thread, consecutive threads along a
// row.
__device__ __forceinline__ void zero_dropped(const wg::Epi& p,
                                             const int* keep, int n_keep,
                                             int heads, int m0,
                                             uint8_t* smem) {
  int* const dropped = reinterpret_cast<int*>(smem);  // [0]: the count
  uint8_t* const kept = smem + 4 * (heads + 1);
  for (int h = threadIdx.x; h < heads; h += blockDim.x) kept[h] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < n_keep; s += blockDim.x) {
    const int h = keep[s];
    if (h >= 0 && h < heads) kept[h] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int h = 0; h < heads; ++h)
      if (!kept[h]) dropped[1 + n++] = h;
    dropped[0] = n;
  }
  __syncthreads();
  // pieces of a row to zero: n heads of 8 (bf16) or 16 (fp32) pieces;
  // 32-bit index steps, no division in the loop
  const int shift = p.c_bf16 ? 3 : 4;
  const int width = dropped[0] << shift;
  if (width == 0) return;
  const int item = p.c_bf16 ? 2 : 4;
  const int rows = min(kZeroRows, p.m - m0);
  const int step_r = blockDim.x / width, step_q = blockDim.x % width;
  int r = threadIdx.x / width, q = threadIdx.x % width;
  char* const c = static_cast<char*>(p.c) + m0 * p.ldc * item;
  for (; r < rows; r += step_r) {
    const int h = dropped[1 + (q >> shift)];
    *reinterpret_cast<uint4*>(c + (r * p.ldc + h * 64) * item +
                              ((q & ((1 << shift) - 1)) << 4)) =
        make_uint4(0, 0, 0, 0);
    q += step_q;
    if (q >= width) q -= width, ++r;
  }
}

// Blocks [0, products): product block b computes slot pair b % pairs of
// row tile b / pairs; the blocks after them are the zero blocks, in order
// of their rows.
__global__ void __launch_bounds__(wg::kThreads, wg::kBlocksPerSm)
    head_compact_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_wt,
                        const wg::Epi p, const int* keep, int n_keep,
                        int heads) {
  extern __shared__ uint8_t smem_raw[];
  const int pairs = (n_keep + 1) / 2;
  const int products = (p.m + wg::BM - 1) / wg::BM * pairs;
  if (static_cast<int>(blockIdx.x) >= products) {
    zero_dropped(p, keep, n_keep, heads,
                 (blockIdx.x - products) * kZeroRows, smem_raw);
    return;
  }
  const int slot = blockIdx.x % pairs;
  const int m0 = blockIdx.x / pairs * wg::BM;
  const int n0 = head_start(keep, 2 * slot, n_keep, heads);
  const int n1 = head_start(keep, 2 * slot + 1, n_keep, heads);
  if (n0 < 0 && n1 < 0) return;
  const wg::Ring ring = wg::make_ring(smem_raw);
  wg::run_tile<false, false, true>(&map_x, &map_wt, p, ring, m0, n0, n1, 0,
                                   (p.k + wg::BK - 1) / wg::BK);
}

}  // namespace

extern "C" {

// The operand pass in copy mode: dst [rows, ldd] bf16 (ldd a multiple of 8,
// dst 16-byte aligned) = bf16(src(r, c)), src(r, c) at src[r * rs + c * cs]
// (bf16 if src_bf16, else fp32). Returns cudaGetLastError() after the
// launch.
int head_compact_operand_pass(const void* src, int64_t rs, int64_t cs,
                              int src_bf16, void* dst, int64_t ldd, int rows,
                              int cols, void* stream) {
  if (rows < 1 || cols < 1 || ldd < cols || ldd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  head_compact_operand_pass_kernel<<<wg::grid_for(rows * (ldd / 8), 256), 256,
                                     0, static_cast<cudaStream_t>(stream)>>>(
      src, rs, cs, src_bf16, static_cast<bf16*>(dst), ldd, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// y[m, heads * 64] (contiguous; bf16 if y_bf16, else fp32) from x [m, k]
// and wt [heads * 64, k], both bf16 with rows on the 16-byte grid (pitches
// in elements); keep: n_keep int32 head indices in device memory. Returns
// 0 or an error code (head_compact_matmul_error_string).
int head_compact_matmul(const void* x, int64_t x_pitch, const void* wt,
                        int64_t wt_pitch, const int* keep, int n_keep,
                        void* y, int m, int k, int heads, int y_bf16,
                        void* stream) {
  if (m < 1 || k < 1 || heads < 1 || heads > kMaxHeads || n_keep < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      static_cast<int64_t>((m + wg::BM - 1) / wg::BM) * ((n_keep + 1) / 2) +
      (m + kZeroRows - 1) / kZeroRows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  wg::Epi p{};
  p.c = y, p.ldc = static_cast<int64_t>(heads) * 64;
  p.m = m, p.n = heads * 64, p.k = k;
  p.mode = wg::kStore, p.c_bf16 = y_bf16;
  p.chunk = (k + wg::BK - 1) / wg::BK;
  CUtensorMap map_x, map_wt;
  int rc = wg::encode(&map_x, x, k, m, x_pitch, 128);
  if (rc) return rc;
  rc = wg::encode(&map_wt, wt, k, p.ldc, wt_pitch, 64);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      head_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  head_compact_kernel<<<static_cast<unsigned>(blocks), wg::kThreads,
                        wg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_wt, p, keep, n_keep, heads);
  return static_cast<int>(cudaGetLastError());
}

const char* head_compact_matmul_error_string(int code) {
  static thread_local char buf[96];
  if (code >= wg::kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - wg::kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
