// A matrix product on Hopper's TMA and `wgmma`, with bf16 operands and fp32
// sums, shared by the masked matmul kernels (masked_matmul.cu) and the
// head-compact matmul (head_compact_matmul.cu):
//
//   C[i, j] = epilogue( sum_kk A[i, kk] * B[kk, j] )        (fp32 sums)
//
// Operands are bf16 in device memory, rows 16-byte aligned, read by TMA
// (whatever is not, the caller first rounds into such a buffer with
// `operand_pass`, below, from its own kernel). Each
// operand is either K-major (its rows run along the reduction: A = x [M, K],
// or B stored as Bᵀ [N, K]) or MN-major (A stored as Aᵀ [K, M], B as
// [K, N]); `wgmma`'s transpose bits read either layout from shared memory,
// so no operand is transposed in device memory.
//
// Design (sm_90a):
// - One block of 288 threads per 128 x 128 tile of C: two consumer
//   warpgroups (64 rows each, `wgmma.mma_async` m64n128k16 with 64 fp32
//   accumulators a thread) and one producer warp whose lane 0 issues the
//   TMA loads. The reduction runs in 64-deep steps.
// - A ring of 3 stages of 32 KB (A and B tiles, 128-byte swizzle, the
//   `wgmma` descriptors matching it), a full and an empty `mbarrier` per
//   stage: the producer waits for a stage to be released, arms its full
//   barrier with the tile bytes and issues the loads; each consumer
//   warpgroup waits for the full barrier, issues four `wgmma`s, and
//   releases the stage of the step before once its own `wgmma`s are done
//   (one group kept in flight).
// - 97 KB of shared memory and at most 112 registers a thread, so two
//   blocks share an SM and one block's epilogue overlaps the other's main
//   loop. At x [9216, 768] @ [768, 768]: 432 tiles on 264 block slots.
// - The epilogue stages each warpgroup's 64 x 128 sums in the freed ring
//   (in C's dtype where C is bf16, else fp32), then writes whole rows,
//   16 bytes a thread. Storing the accumulators directly (two columns a
//   thread, so 16-byte pieces of eight rows a warp store) took about as
//   long as the main loop at that shape on an H100.
// - Ragged edges: TMA fills the rows and columns past the operand with
//   zeros, and the epilogue writes only the inside of C.
// - Epilogue modes: C in bf16 or fp32; C times the fp32 value of E,
//   rounded to E's dtype, stored fp32 (the STE epilogue of ds); or an fp32
//   partial sum of one split of the reduction (blockIdx.z), which a second
//   pass adds in split order.
// - Tried on an H100 at that shape and left out: 128 x 256 tiles (one
//   block an SM), and clusters of two blocks sharing the B tile through
//   TMA multicast; neither was faster.
// - Head mode (`kHeads`, the head-compact matmul): B is K-major and its
//   two 64-row atoms come from rows n0 and n1 of B, two 64 x 64 TMA boxes
//   a stage; the tile's column halves go to columns n0 and n1 of C. A
//   negative n0 or n1 loads and writes nothing for that half, and the
//   stage's barrier expects only the bytes requested.
//
// Tensor maps are encoded on the host for every launch (so a captured
// CUDA graph holds the maps of its own buffers) through the driver's
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint: no link
// against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 3;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;
constexpr int kBlocksPerSm = 2;
constexpr int kAtom = 64 * BK * 2;        // 64 rows (or columns) x BK: 8 KB
constexpr int kTileBytes = 2 * kAtom;     // an A or a B tile: 16 KB
constexpr int kSmemBytes = 1024 + kStages * 2 * kTileBytes + kStages * 16;
// the epilogue's staging rows, in elements: 16-byte aligned, and 4 banks
// (bf16) or 8 banks (fp32) apart, so neither phase has bank conflicts
constexpr int kPitch16 = BN + 8, kPitch32 = BN + 8;
static_assert(2 * 64 * kPitch32 * 4 <= kStages * 2 * kTileBytes,
              "the staged sums fit in the ring");

enum Mode { kStore = 0, kSte = 1, kPartial = 2 };

// What the epilogue writes, and where the block's split of the
// reduction lies.
struct Epi {
  void* c;          // C(i, j) at c[i * ldc + j] (kPartial: + z * m * ldc)
  int64_t ldc;
  const void* e;    // kSte: E(i, j) at e[i * lde + j]
  int64_t lde;
  int m, n, k;      // C is m x n; the sums run over k
  int mode;
  int c_bf16;       // kStore: C is bf16 (1) or fp32 (0)
  int e_bf16;       // kSte: E is bf16 (1) or fp32 (0)
  int chunk;        // reduction steps of BK per split (blockIdx.z)
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed. A wait of
// about ten seconds (2^34 cycles) traps, so a pipeline fault surfaces as a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One 2-D TMA load of the box at (c0 inner, c1 outer) into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all in bytes here).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// `kCount` threads (whole warps) meet at named barrier `kId`.
template <int kId, int kCount>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kCount) : "memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16 in, fp32 sums in registers.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// ----------------------------------------------------------- epilogue

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// Writes `len` (<= 8) sums of row i from column j on, as p.mode says; a
// whole 16-byte piece in one store where it lies inside C and on the grid.
__device__ __forceinline__ void write_piece(const Epi& p, int i, int j,
                                            const float* v, int len) {
  const int64_t at = static_cast<int64_t>(i) * p.ldc + j;
  const int live = min(len, p.n - j);
  if (p.mode == kStore && p.c_bf16) {
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.c) + at;
    if (live == 8 && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      *reinterpret_cast<uint4*>(c) = u;
    } else {
      for (int q = 0; q < live; ++q) c[q] = __float2bfloat16(v[q]);
    }
    return;
  }
  float w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) w[q] = v[q];
  if (p.mode == kSte) {
    const int64_t ea = static_cast<int64_t>(i) * p.lde + j;
    for (int q = 0; q < live; ++q) {
      if (p.e_bf16) {
        w[q] = bf16_round(
            w[q] * __bfloat162float(
                       static_cast<const __nv_bfloat16*>(p.e)[ea + q]));
      } else {
        w[q] *= static_cast<const float*>(p.e)[ea + q];
      }
    }
  }
  float* c = static_cast<float*>(p.c) + at;
  if (p.mode == kPartial)
    c += static_cast<int64_t>(blockIdx.z) * p.m * p.ldc;
  if (live == len && len == 4 && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
    *reinterpret_cast<float4*>(c) = make_float4(w[0], w[1], w[2], w[3]);
  } else {
    for (int q = 0; q < live; ++q) c[q] = w[q];
  }
}

// C's column of the tile's column j: n0 + j, or in head mode that of the
// half's head (from n0 for j < 64, else n1); a half with a negative start
// maps past every column, so nothing of it is written.
template <bool kHeads>
__device__ __forceinline__ int column(int n0, int n1, int j) {
  if constexpr (kHeads) {
    const int base = j < 64 ? n0 : n1;
    return base < 0 ? INT_MAX : base + (j & 63);
  } else {
    return n0 + j;
  }
}

// ------------------------------------------------------- operand pass

__device__ __forceinline__ float load_f32(const void* p, int64_t i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The body of an operand pass kernel: dst[r, c] (bf16, row pitch ldd, a
// multiple of 8) = bf16(src(r, c) ⊙ [s(r, c) > *t]) (mask mode, s !=
// nullptr; s shares src's strides) or bf16(src(r, c)) (copy mode), src(r,
// c) at src[r * rs + c * cs], bf16 if src_bf16 else fp32; zeros in the
// columns [cols, ldd). One thread per 8 columns of a row, over a grid
// stride loop; consecutive threads on src's contiguous dimension; 16-byte
// loads where the source allows them. Each library wraps it in its own
// kernel, so its launches are its own.
__device__ __forceinline__ void operand_pass(const void* src, int64_t rs,
                                             int64_t cs, int src_bf16,
                                             const float* s, const float* t,
                                             __nv_bfloat16* dst, int64_t ldd,
                                             int rows, int cols) {
  const float thr = s ? *t : 0.f;
  const int64_t chunks = ldd / 8;
  const int64_t total = rows * chunks;
  const bool row_fast = cs != 1;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = row_fast ? idx % rows : idx / chunks;
    const int c0 = static_cast<int>(8 * (row_fast ? idx / rows : idx % chunks));
    const int64_t off = r * rs + c0 * cs;
    float v[8], sv[8];
    const char* sp = static_cast<const char*>(src) + off * (src_bf16 ? 2 : 4);
    const bool vec = cs == 1 && c0 + 8 <= cols && aligned16(sp) &&
                     (!s || aligned16(s + off));
    if (vec) {
      if (src_bf16) {
        const uint4 u = *reinterpret_cast<const uint4*>(sp);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(h[q]);
      } else {
        const float4 f0 = reinterpret_cast<const float4*>(sp)[0];
        const float4 f1 = reinterpret_cast<const float4*>(sp)[1];
        v[0] = f0.x, v[1] = f0.y, v[2] = f0.z, v[3] = f0.w;
        v[4] = f1.x, v[5] = f1.y, v[6] = f1.z, v[7] = f1.w;
      }
      if (s) {
        const float4 s0 = reinterpret_cast<const float4*>(s + off)[0];
        const float4 s1 = reinterpret_cast<const float4*>(s + off)[1];
        sv[0] = s0.x, sv[1] = s0.y, sv[2] = s0.z, sv[3] = s0.w;
        sv[4] = s1.x, sv[5] = s1.y, sv[6] = s1.z, sv[7] = s1.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const bool in = c0 + q < cols;
        v[q] = in ? load_f32(src, off + q * cs, src_bf16) : 0.f;
        sv[q] = in && s ? s[off + q * cs] : 0.f;
      }
    }
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // the mask in w's dtype times w, as (w * mask).astype(bf16): the
      // product is exact, so one rounding of the fp32 product
      const float x = s ? v[q] * (sv[q] > thr ? 1.f : 0.f) : v[q];
      o[q] = c0 + q < cols ? __float2bfloat16(x) : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(dst + r * ldd + c0) = out;
  }
}

// Blocks of `threads` for a grid stride loop over `work` items (at most
// 8192 blocks).
inline int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return static_cast<int>(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

// ------------------------------------------------------------- kernel

// The ring in dynamic shared memory and its barriers.
struct Ring {
  uint8_t* ptr;          // generic address (the epilogue stages sums here)
  uint32_t a, b;         // shared addresses of stage 0's A and B tiles
  uint32_t full, empty;  // stage s's barriers at full + 8 s, empty + 8 s
};

// Lays the ring out in `smem_raw` and initialises its barriers; every
// thread of the block calls it.
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring r;
  r.ptr = smem_raw + (base - smem_u32(smem_raw));
  r.a = base;
  r.b = base + kStages * kTileBytes;
  r.full = base + 2 * kStages * kTileBytes;
  r.empty = r.full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer warp's lane 0: keeps the ring full for `steps` steps from
// step `first`. kHeads: B's atoms from rows n0 and n1 (header note).
template <bool kTransA, bool kTransB, bool kHeads>
__device__ __forceinline__ void produce(const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        const Ring& ring, int m0, int n0,
                                        int n1, int first, int steps) {
  static_assert(!kHeads || !kTransB, "head atoms are K-major rows of B");
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(ring.empty + 8 * stage, phase ^ 1);
    const uint32_t bar = ring.full + 8 * stage;
    if constexpr (kHeads) {
      mbar_expect_tx(bar, kTileBytes + kAtom * ((n0 >= 0) + (n1 >= 0)));
    } else {
      mbar_expect_tx(bar, 2 * kTileBytes);
    }
    const int k0 = (first + it) * BK;
    const uint32_t a = ring.a + stage * kTileBytes;
    const uint32_t b = ring.b + stage * kTileBytes;
    if (kTransA) {
      tma_load(a, map_a, bar, m0, k0);
      tma_load(a + kAtom, map_a, bar, m0 + 64, k0);
    } else {
      tma_load(a, map_a, bar, k0, m0);
    }
    if constexpr (kHeads) {
      if (n0 >= 0) tma_load(b, map_b, bar, k0, n0);
      if (n1 >= 0) tma_load(b + kAtom, map_b, bar, k0, n1);
    } else if (kTransB) {
      tma_load(b, map_b, bar, n0, k0);
      tma_load(b + kAtom, map_b, bar, n0 + 64, k0);
    } else {
      tma_load(b, map_b, bar, k0, n0);
    }
    if (++stage == kStages) stage = 0, phase ^= 1;
  }
}

// The two consumer warpgroups: the products, the sums staged in the ring,
// and C written out (kHeads: the column halves to columns n0 and n1).
template <bool kTransA, bool kTransB, bool kHeads>
__device__ __forceinline__ void consume(const Epi& p, const Ring& ring,
                                        int m0, int n0, int n1, int steps) {
  const int warp = threadIdx.x / 32;
  // consumers: warpgroup `grp` owns rows [64 grp, 64 grp + 64) of the tile
  const int grp = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(ring.full + 8 * stage, phase);
    const uint32_t a = ring.a + stage * kTileBytes + grp * kAtom;
    const uint32_t b = ring.b + stage * kTileBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: 16 columns are 32 bytes along the swizzled 128-byte rows;
      // MN-major: 16 rows of 128 bytes. Stride offset: 8 rows of 128
      // bytes; MN-major leading offset: the next 64 columns.
      const uint64_t da = kTransA ? make_desc(a + kk * 2048, kAtom, 1024)
                                  : make_desc(a + kk * 32, 16, 1024);
      const uint64_t db = kTransB ? make_desc(b + kk * 2048, kAtom, 1024)
                                  : make_desc(b + kk * 32, 16, 1024);
      wgmma_m64n128k16<kTransA, kTransB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the step before is done: release its stage
    fence_acc(acc);
    if (it > 0 && threadIdx.x % 128 == 0) mbar_arrive(ring.empty + 8 * prev);
    prev = stage;
    if (++stage == kStages) stage = 0, phase ^= 1;
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Stage the sums: accumulator j of n8 block q sits at row lane / 4
  // (+ 8 for j >= 2) of the warp's 16, column 8 q + 2 (lane % 4) (+ 1 for
  // odd j). Both warpgroups are past their last `wgmma` before either
  // overwrites the ring.
  bar_sync<1, 2 * 128>();
  const int lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const bool stage16 = p.mode == kStore && p.c_bf16;
  if (stage16) {
    __nv_bfloat16* st =
        reinterpret_cast<__nv_bfloat16*>(ring.ptr) + grp * 64 * kPitch16;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = q * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(st + r0 * kPitch16 + col) =
          __floats2bfloat162_rn(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8) * kPitch16 + col) =
          __floats2bfloat162_rn(acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
    float* st = reinterpret_cast<float*>(ring.ptr) + grp * 64 * kPitch32;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = q * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(st + r0 * kPitch32 + col) =
          make_float2(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<float2*>(st + (r0 + 8) * kPitch32 + col) =
          make_float2(acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  if (grp == 0) bar_sync<2, 128>(); else bar_sync<3, 128>();

  // Write the warpgroup's 64 rows: consecutive threads on consecutive
  // 16-byte pieces of a row.
  const int t = threadIdx.x % 128;
  const int row0 = m0 + grp * 64;
  if (stage16) {
    const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(ring.ptr) +
                              grp * 64 * kPitch16;
    constexpr int kPieces = BN / 8;
    for (int idx = t; idx < 64 * kPieces; idx += 128) {
      const int r = idx / kPieces, j = (idx % kPieces) * 8;
      const int col = column<kHeads>(n0, n1, j);
      if (row0 + r >= p.m || col >= p.n) continue;
      const uint4 u =
          *reinterpret_cast<const uint4*>(st + r * kPitch16 + j);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(h[q]);
      write_piece(p, row0 + r, col, v, 8);  // exact: v is bf16 already
    }
  } else {
    const float* st =
        reinterpret_cast<const float*>(ring.ptr) + grp * 64 * kPitch32;
    constexpr int kPieces = BN / 4;
    for (int idx = t; idx < 64 * kPieces; idx += 128) {
      const int r = idx / kPieces, j = (idx % kPieces) * 4;
      const int col = column<kHeads>(n0, n1, j);
      if (row0 + r >= p.m || col >= p.n) continue;
      const float4 f = *reinterpret_cast<const float4*>(st + r * kPitch32 + j);
      const float v[8] = {f.x, f.y, f.z, f.w, 0.f, 0.f, 0.f, 0.f};
      write_piece(p, row0 + r, col, v, 4);
    }
  }
}

// The producer warp and the two consumer warpgroups of one tile: C's rows
// [m0, m0 + BM) and columns [n0, n0 + BN) (kHeads: the halves at n0 and
// n1), summed over reduction steps [first, first + steps).
template <bool kTransA, bool kTransB, bool kHeads>
__device__ __forceinline__ void run_tile(const CUtensorMap* map_a,
                                         const CUtensorMap* map_b,
                                         const Epi& p, const Ring& ring,
                                         int m0, int n0, int n1, int first,
                                         int steps) {
  if (threadIdx.x / 32 == kConsumerWarps) {
    if (threadIdx.x % 32 == 0)
      produce<kTransA, kTransB, kHeads>(map_a, map_b, ring, m0, n0, n1,
                                        first, steps);
  } else {
    consume<kTransA, kTransB, kHeads>(p, ring, m0, n0, n1, steps);
  }
}

// kTransA: A is MN-major (stored [K, M]); else K-major ([M, K]).
// kTransB: B is MN-major (stored [K, N]); else K-major ([N, K]).
// The maps' boxes: 64 x 128 (inner x outer) for a K-major operand, one
// load a stage; 64 x 64 for an MN-major one, two loads (the 64-column
// halves) a stage. Block z sums split z of the reduction.
template <bool kTransA, bool kTransB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const Epi p) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int first = blockIdx.z * p.chunk;
  const int steps = min((p.k + BK - 1) / BK - first, p.chunk);
  run_tile<kTransA, kTransB, false>(&map_a, &map_b, p, ring, m0, n0, 0, first,
                                    steps);
}

// --------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes past this mark are a CUresult of cuTensorMapEncodeTiled.
constexpr int kEncodeError = 100000;

struct Encoder {
  EncodeTiled fn;
  cudaError_t status;
};

inline Encoder encoder() {
  static const Encoder found = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && (q != cudaDriverEntryPointSuccess || !fn))
      e = cudaErrorSymbolNotFound;
    return Encoder{reinterpret_cast<EncodeTiled>(fn), e};
  }();
  return found;
}

// A bf16 matrix of `outer` rows of `inner` elements, `pitch` elements
// apart, read in boxes of 64 x box_outer with the 128-byte swizzle; zeros
// past its edges.
inline int encode(CUtensorMap* map, const void* ptr, int64_t inner,
                  int64_t outer, int64_t pitch, uint32_t box_outer) {
  const Encoder enc = encoder();
  if (enc.status != cudaSuccess) return static_cast<int>(enc.status);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 2};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc.fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// C = A B as `p` says, A at `a` (row pitch a_pitch elements), B at `b`,
// over ceil(m / BM) x ceil(n / BN) tiles x `splits` splits of the
// reduction; returns 0 or an error code (cudaError_t, or kEncodeError +
// CUresult).
template <bool kTransA, bool kTransB>
int launch(const void* a, int64_t a_pitch, const void* b, int64_t b_pitch,
           const Epi& p, int splits, cudaStream_t stream) {
  const int64_t row_tiles = (p.m + BM - 1) / BM;
  if (p.m < 1 || p.n < 1 || p.k < 1 || row_tiles > 65535 || splits < 1 ||
      p.chunk < 1 || static_cast<int64_t>(splits - 1) * p.chunk * BK >= p.k)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  int rc = kTransA ? encode(&map_a, a, p.m, p.k, a_pitch, 64)
                   : encode(&map_a, a, p.k, p.m, a_pitch, 128);
  if (rc) return rc;
  rc = kTransB ? encode(&map_b, b, p.n, p.k, b_pitch, 64)
               : encode(&map_b, b, p.k, p.n, b_pitch, 128);
  if (rc) return rc;
  auto kernel = wgmma_gemm_kernel<kTransA, kTransB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.n + BN - 1) / BN, static_cast<unsigned>(row_tiles),
                  splits);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_b, p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the <kTransA, kTransB> kernel that one SM holds at once.
template <bool kTransA, bool kTransB>
int blocks_per_sm() {
  auto kernel = wgmma_gemm_kernel<kTransA, kTransB>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace wg
