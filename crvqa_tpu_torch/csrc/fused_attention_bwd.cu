// Fused short-sequence multi-head attention, backward, for NVIDIA Hopper
// (sm_90a): bf16 on the tensor cores (mma.sync), fp32 on scalar FMAs.
//
// Replaces two TPU kernels of `crvqa_tpu/ops/fused_attention.py`, reached
// from `_fas_bwd` -> `_fa_bwd`:
//
// - `_bwd_kernel_stored` (the default, BWD_IMPL = "stored", and
//   "stored_folddot", which only spells the TPU's fold of the head blocks
//   of dk and dv otherwise: here each block sums its own head's rows, so
//   both are this kernel): p is the forward's residual [B, Sq, H*Sk]
//   (fused_attention_fwd_train), fp32 or, with `p_bf16` (P_RESIDUAL_DTYPE
//   = bf16), bf16 widened to fp32 on load, all math in fp32 as the TPU
//   kernel's `p_ref[b].astype(jnp.float32)`;
// - `_bwd_kernel` (BWD_IMPL = "recompute"): p is rebuilt from q, k and the
//   key bias with the forward's own score and softmax code
//   (fused_attention_common.cuh), so it equals the stored p bit for bit.
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
// What bounds it on this card: memory. A call reads q, g, k, v (activation
// dtype) and, for the stored variant, the residual (4 or 2 bytes an
// element), and writes dq, dk,
// dv: at batch 256, (36, 36), bf16 about 115 MB against 8*B*H*Sq*Sk*D =
// 0.16 GFLOP, far under the H100's ~295 FLOP per HBM byte. The recompute
// variant reads the [B, Sk] bias instead of the residual and does
// 10*B*H*Sq*Sk*D FLOPs. Each block's work is small, so latency (loads in
// flight, dependent instructions, blocks resident per SM) sets the pace.
//
// bf16 design (`fused_attention_bwd_mma_kernel`): one block per (head,
// batch row) holding every query row and key, so dk and dv sum over query
// rows inside the block, with no atomics and the same bits on every run.
// Up to 8 warps (max(Sq, Sk) / 16 tiles; 3 at (36, 36)).
//
// 1. Staging: q, g (Sq rows) and k, v (Sk rows) by 16-byte cp.async into
//    bf16 rows padded to 144 bytes (28 KB at (36, 36), against 53 KB of
//    fp32 tiles before), zero-filled to whole 16-row tiles; the stored
//    variant's p rows by 16-byte cp.async when a row is whole 16-byte
//    units (Sk % 4 == 0 in fp32, % 8 in bf16), else 8- or 4-byte (a
//    single bf16 by a plain load when Sk is odd), into a [Sq][Sk + 8]
//    plane of the residual's type (the bf16 plane fills half the fp32
//    plane's room); the recompute variant's bias.
// 2. Rows (one warp per 16 query rows, in chunks of 8 NT keys, NT 2 or 6):
//    p from the plane (widened to fp32), or S = Q K^T and the forward's
//    `fa::RowSoftmax` /
//    `fa::prob`; dP = G V^T (`fa::abt_tile`), times drop; rowsum(dp * p)
//    in registers and by quad shuffles; then ds and p_t rounded to bf16
//    into two shared [Sq][Sk + 8] planes. A row longer than 48 keys (Sk
//    49-85 at 12 heads; none on LXMERT's or mPLUG's paths) is recomputed
//    chunk by chunk for each of these passes.
// 3. Products, after one barrier, one 16-row output tile per warp at a
//    time: dQ = dS K (dS rows by `ldmatrix`, K by `ldmatrix.trans`),
//    dV = P_t^T G and dK = dS^T Q (the planes by `ldmatrix.trans`, giving
//    transposed A operands; G and Q by `ldmatrix.trans`), each staged in
//    the warp's slot of the now-dead V / p region and written as 16-byte
//    bf16 rows.
//
// Shared memory (`bwd_plan`, mirrored by the wrapper's `bwd_smem_bytes`)
// is 48 KB stored / 38 KB recompute at (36, 36), so 4-5 blocks fit an SM
// (80-128 registers a thread allow 5 or more); a shape over the 227 KB a
// block may use is refused before launch (the wrapper raises). Every shape
// the scalar fp32 kernel takes fits.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, device
// time under CUDA-graph replay): per stage-2 step at batch 256 (32 calls,
// dropout 0.1) the stored variant takes 1.084 ms (bound 0.683;
// scaled_dot_product_attention's forward + backward under autograd 7.428;
// the scalar kernel this design replaced 5.384) and the recompute variant
// 1.069 ms (bound 0.614; the scalar kernel 7.251). At (36, 36) a stored
// call moves its 115 MB at 58% of the HBM rate.
//
// fp32 stays on the scalar kernel below (`fused_attention_bwd_kernel`):
// fp32 on the tensor cores is TF32, about three decimal digits, and the
// fp32 path is held to the plain version at 1e-4. Its design: one block of
// 256 threads per (head, batch row); q, g, k, v as fp32 with a row pitch of
// 65 floats and the [Sq, Sk] p, dp/ds and p_t tiles in shared memory (53 KB
// at (36, 36)); the five products as scalar FMAs, one output element per
// thread.

#include "fused_attention_common.cuh"

namespace {

using fa::kHeadDim;
using fa::kMaxHeadsTimesSeq;
using fa::kPitch;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper

size_t smem_bytes(int sq, int sk) {
  return sizeof(float) * ((size_t)(2 * sq + 2 * sk) * kPitch +
                          (size_t)3 * sq * sk);
}

// [S, D] head slice (row stride in elements) -> fp32 [S][kPitch]
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t row_stride, int rows) {
  for (int i = threadIdx.x; i < rows * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[r * kPitch + c] = src[(int64_t)r * row_stride + c];
  }
}

// P: the stored residual's element type (float, or bf16 for the bf16
// residual; float for the recompute variant, which has none).
template <bool kStored, typename P>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const P* __restrict__ p_in,
        const float* __restrict__ bias, const float* __restrict__ g,
        float* __restrict__ dq, float* __restrict__ dk,
        float* __restrict__ dv, int sq, int sk, int heads, int64_t q_sb,
        int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb,
        int64_t v_ss, int64_t g_sb, int64_t g_ss, float scale,
        uint32_t seed, uint32_t batch0, uint32_t col0, uint32_t threshold,
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
      ps[idx] = fa::load_p(p_in + ((int64_t)b * sq + i) * heads * sk +
                           (int64_t)h * sk + j);
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
  const uint32_t key = fa::keep_key_at(seed, (uint32_t)b + batch0, col0);
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
    pt[idx] = ps[idx] * drop;
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
      dsrow[j] = (dsrow[j] - sum) * prow[j] * scale;
  }
  __syncthreads();

  // dq = ds k: one (row, column) per thread
  for (int idx = tid; idx < sq * kHeadDim; idx += kThreads) {
    const int i = idx / kHeadDim, c = idx % kHeadDim;
    const float* dsrow = ds + i * sk;
    float acc = 0.f;
    for (int j = 0; j < sk; ++j) acc = fmaf(dsrow[j], ks[j * kPitch + c], acc);
    dq[((int64_t)b * sq + i) * width + h * kHeadDim + c] = acc;
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
    dk[o] = acck;
    dv[o] = accv;
  }
}

template <bool kStored, typename P>
int launch_typed(const void* q, const void* k, const void* v,
                 const P* p_in, const float* bias, const void* g, void* dq, void* dk, void* dv, int batch, int sq, int sk,
                 int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                 int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t g_sb,
                 int64_t g_ss, uint32_t seed, uint32_t batch0, uint32_t col0,
                     uint32_t threshold,
                 float keep_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(sq, sk);
  auto kernel = fused_attention_bwd_kernel<kStored, P>;
  // once per instantiation, at the first launch (not inside a CUDA graph
  // capture of a later one): allow up to the 227 KB a block may use
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  kernel<<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), p_in, bias, static_cast<const float*>(g),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, heads, q_sb, q_ss, k_sb, k_ss, v_sb,
      v_ss, g_sb, g_ss, scale, seed, batch0, col0, threshold, keep_scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16, tensor cores

using fa::bf16;
using fa::kMmaPitch;

constexpr int kMmaMaxWarps = 8;
constexpr int kSlot = 16 * kMmaPitch;  // a warp's output staging, in bf16

// The bf16 block's shared memory at (Sq, Sk), in bytes from its start:
// q, g ([sqp][kMmaPitch] bf16), k, the ds and p_t planes ([sqp][pd] bf16),
// then the row phase's V ([skp][kMmaPitch]) and the stored p plane
// ([sqp][pd] fp32; a bf16 residual's plane fills the first half) or the
// recompute bias ([skp] fp32), which the product
// phase reuses as one output slot per warp. sqp and skp are Sq and Sk
// padded to whole 16-row tiles; pd = skp + 8 keeps each plane's rows 16-
// byte aligned and its `ldmatrix` and 8-byte reads free of bank conflicts.
struct BwdPlan {
  int sqp, skp, pd, warps;
  size_t g, k, ds, pt, v, p, total;
};

__host__ __device__ inline BwdPlan bwd_plan(int sq, int sk, bool stored) {
  BwdPlan pl;
  pl.sqp = 16 * ((sq + 15) / 16);
  pl.skp = 16 * ((sk + 15) / 16);
  pl.pd = pl.skp + 8;
  const int tiles = (pl.sqp > pl.skp ? pl.sqp : pl.skp) / 16;
  pl.warps = tiles < kMmaMaxWarps ? tiles : kMmaMaxWarps;
  const size_t row = sizeof(bf16) * kMmaPitch;  // 144 bytes
  const size_t plane = sizeof(bf16) * pl.sqp * pl.pd;
  pl.g = row * pl.sqp;
  pl.k = pl.g + row * pl.sqp;
  pl.ds = pl.k + row * pl.skp;
  pl.pt = pl.ds + plane;
  pl.v = pl.pt + plane;
  pl.p = pl.v + row * pl.skp;
  const size_t tail =
      row * pl.skp + (stored ? 2 * plane : sizeof(float) * pl.skp);
  const size_t slots = sizeof(bf16) * kSlot * pl.warps;
  pl.total = pl.v + (tail > slots ? tail : slots);
  return pl;
}

// `p_vec` (stored): residual elements per copy of the p rows, as many as
// fill 16 bytes (4 fp32, 8 bf16) when a row is whole 16-byte units and the
// residual starts 16-byte aligned, else 8 or 4 bytes' worth, else 1 (a
// bf16 row of odd length: plain 2-byte copies). P: the residual's and its
// plane's element type (float, or bf16; float for the recompute variant).
// Rate 0 is threshold 0 with keep_scale 1: every bit kept, drop == 1.
template <bool kStored, int NT, typename P>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
    fused_attention_bwd_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const P* __restrict__ p_in,
        const float* __restrict__ bias,
        const bf16* __restrict__ g, bf16* __restrict__ dq,
        bf16* __restrict__ dk, bf16* __restrict__ dv,
        int sq, int sk, int heads, int64_t q_sb, int64_t q_ss, int64_t k_sb,
        int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t g_sb,
        int64_t g_ss, float scale, uint32_t seed, uint32_t batch0,
        uint32_t col0, uint32_t threshold,
        float keep_scale, int p_vec) {
  constexpr int kKeys = 8 * NT;  // keys a chunk (the register row)
  static_assert(4 * NT <= 32, "the keep bits of a chunk fill one word");
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const BwdPlan pl = bwd_plan(sq, sk, kStored);
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);
  bf16* gs = reinterpret_cast<bf16*>(mma_smem + pl.g);
  bf16* ks = reinterpret_cast<bf16*>(mma_smem + pl.k);
  bf16* ds_s = reinterpret_cast<bf16*>(mma_smem + pl.ds);
  bf16* pt_s = reinterpret_cast<bf16*>(mma_smem + pl.pt);
  bf16* vs = reinterpret_cast<bf16*>(mma_smem + pl.v);
  float* ps = reinterpret_cast<float*>(mma_smem + pl.p);  // the bias
  P* pp = reinterpret_cast<P*>(mma_smem + pl.p);          // or the p plane

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, c = lane & 3;
  const int nthreads = blockDim.x, warps = pl.warps;
  const int row_tiles = pl.sqp / 16, key_tiles = pl.skp / 16;

  // 1. staging
  fa::stage_rows(qs, q + b * q_sb + h * kHeadDim, q_ss, 0, pl.sqp, sq, tid,
                 nthreads);
  fa::stage_rows(gs, g + b * g_sb + h * kHeadDim, g_ss, 0, pl.sqp, sq, tid,
                 nthreads);
  fa::stage_rows(ks, k + b * k_sb + h * kHeadDim, k_ss, 0, pl.skp, sk, tid,
                 nthreads);
  fa::stage_rows(vs, v + b * v_sb + h * kHeadDim, v_ss, 0, pl.skp, sk, tid,
                 nthreads);
  if (kStored) {
    const int bytes = p_vec * (int)sizeof(P);  // 16, 8, 4, or 2 (one bf16)
    const int per_row = pl.skp / p_vec;
    for (int x = tid; x < pl.sqp * per_row; x += nthreads) {
      const int r = x / per_row, col = (x - r * per_row) * p_vec;
      const bool in = r < sq && col < sk;
      const P* src = p_in + ((int64_t)(b * sq + (in ? r : 0)) * heads + h) *
                                sk + (in ? col : 0);
      P* dst = pp + r * pl.pd + col;
      if (bytes == 16)
        fa::cp_async_16(dst, src, in ? 16 : 0);
      else if (bytes == 8)
        fa::cp_async_8(dst, src, in ? 8 : 0);
      else if (sizeof(P) == 4 || bytes == 4)
        fa::cp_async_4(dst, src, in ? 4 : 0);
      else if constexpr (sizeof(P) == 2)  // one bf16 (Sk odd)
        *dst = in ? *src : __float2bfloat16(0.f);
    }
  } else {
    for (int x = tid; x < pl.skp; x += nthreads) {
      const bool in = x < sk;
      fa::cp_async_4(ps + x, bias + (int64_t)b * sk + (in ? x : 0),
                     in ? 4 : 0);
    }
  }
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  // 2. rows: p, dp * drop, rowsum, then the ds and p_t planes
  const uint32_t key = fa::keep_key_at(seed, (uint32_t)b + batch0, col0);
  const int nch = (sk + kKeys - 1) / kKeys;
  for (int rt = warp; rt < row_tiles; rt += warps) {
    const int r0 = 16 * rt;
    uint32_t qa[4][4], ga[4][4];
    fa::load_a(ga, gs, r0, lane);
    if (!kStored) fa::load_a(qa, qs, r0, lane);
    float p[NT][4], d[NT][4];
    uint32_t kept = 0;  // bit 4n + e: the keep bit of (n, e)
    fa::RowSoftmax st;
    if (!kStored) {  // the forward's statistics, from the same scores
      st.init();
      for (int ch = 0; ch < nch; ++ch) {
        fa::chunk_scores<NT>(p, qa, ks, ch * kKeys, ps + ch * kKeys,
                             ch * kKeys, sk, scale, lane);
        st.add_max(p);
      }
      st.quad_max();
      for (int ch = 0; ch < nch; ++ch) {
        if (nch > 1)
          fa::chunk_scores<NT>(p, qa, ks, ch * kKeys, ps + ch * kKeys,
                               ch * kKeys, sk, scale, lane);
        st.add_sum(p);
      }
      st.finish();
    }
    // p, d = dp * drop and the keep bits of chunk ch; `scored`: p holds
    // the chunk's scores already (recompute, one chunk)
    auto chunk = [&](int ch, bool scored) {
      const int j0 = ch * kKeys;
      if (kStored) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 x = make_float2(0.f, 0.f);
            if (j0 + 8 * n < sk)
              x = fa::load_p2(pp + (r0 + gr + 8 * r) * pl.pd + j0 + 8 * n +
                              2 * c);
            p[n][2 * r] = x.x;
            p[n][2 * r + 1] = x.y;
          }
        }
      } else {
        if (!scored)
          fa::chunk_scores<NT>(p, qa, ks, j0, ps + j0, j0, sk, scale, lane);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[n][e] = fa::prob(p[n][e], st.m[e >> 1], st.l[e >> 1]);
        }
      }
      kept = 0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (j0 + 8 * n < sk)
          fa::abt_tile(d[n], ga, vs, j0 + 8 * n, lane);
        else
          d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float drop = fa::drop_at(
              key, (uint32_t)(r0 + gr + 8 * (e >> 1)),
              (uint32_t)(h * sk + j0 + 8 * n + 2 * c + (e & 1)), threshold,
              keep_scale);
          d[n][e] = __fmul_rn(d[n][e], drop);
          kept |= (drop != 0.f ? 1u : 0u) << (4 * n + e);
        }
      }
    };
    float rs[2] = {0.f, 0.f};
    for (int ch = 0; ch < nch; ++ch) {
      chunk(ch, !kStored && nch == 1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rs[e >> 1] = __fadd_rn(rs[e >> 1], __fmul_rn(d[n][e], p[n][e]));
      }
    }
    rs[0] = fa::quad_sum(rs[0]);
    rs[1] = fa::quad_sum(rs[1]);
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) chunk(ch, false);
      const int j0 = ch * kKeys;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (j0 + 8 * n >= pl.skp) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r0 + gr + 8 * r;
          float x[2], y[2];  // ds, p_t
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int el = 2 * r + e;
            const float pe = p[n][el];
            x[e] = i < sq ? __fmul_rn(__fmul_rn(__fsub_rn(d[n][el], rs[r]),
                                                pe),
                                      scale)
                          : 0.f;
            y[e] = i < sq && ((kept >> (4 * n + el)) & 1u)
                       ? __fmul_rn(pe, keep_scale)
                       : 0.f;
          }
          const int at = i * pl.pd + j0 + 8 * n + 2 * c;
          *reinterpret_cast<uint32_t*>(ds_s + at) = fa::pack_bf16(x[0], x[1]);
          *reinterpret_cast<uint32_t*>(pt_s + at) = fa::pack_bf16(y[0], y[1]);
        }
      }
    }
  }
  __syncthreads();  // the planes are whole; V and p (or the bias) are dead

  // 3. products, one 16-row output tile per warp at a time
  bf16* slot = vs + warp * kSlot;
  const int64_t ld = (int64_t)heads * kHeadDim;
  for (int job = warp; job < row_tiles + key_tiles; job += warps) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (job < row_tiles) {  // dq = ds k
      const int r0 = 16 * job;
      for (int j = 0; j < pl.skp; j += 16) {
        uint32_t a[4];
        fa::ldmatrix_x4(a[0], a[1], a[2], a[3],
                        ds_s + (r0 + (lane & 15)) * pl.pd + j +
                            (lane >> 4) * 8);
        fa::mma_ab16(acc, a, ks, j, lane);
      }
      fa::store_tile(dq + (int64_t)b * sq * ld + h * kHeadDim, ld, r0, sq,
                     acc, slot, lane);
    } else {  // dv = p_t^T g, dk = ds^T q: transposed A operands
      const int k0 = 16 * (job - row_tiles);
      const int arow = (lane & 7) + ((lane >> 4) & 1) * 8;
      const int acol = k0 + ((lane >> 3) & 1) * 8;
      bf16* const outs[2] = {dv, dk};
      const bf16* const planes[2] = {pt_s, ds_s};
      const bf16* const tiles[2] = {gs, qs};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w == 1) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        }
        for (int i = 0; i < pl.sqp; i += 16) {
          uint32_t a[4];
          fa::ldmatrix_x4_trans(a[0], a[1], a[2], a[3],
                                planes[w] + (i + arow) * pl.pd + acol);
          fa::mma_ab16(acc, a, tiles[w], i, lane);
        }
        fa::store_tile(outs[w] + (int64_t)b * sk * ld + h * kHeadDim, ld, k0,
                       sk, acc, slot, lane);
      }
    }
  }
}

template <bool kStored, int NT, typename P>
int launch_mma(const void* q, const void* k, const void* v,
               const P* p_in, const float* bias, const void* g, void* dq,
               void* dk, void* dv, int batch, int sq, int sk, int heads,
               int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
               int64_t v_sb, int64_t v_ss, int64_t g_sb, int64_t g_ss,
               uint32_t seed, uint32_t batch0, uint32_t col0,
                   uint32_t threshold, float keep_scale,
               cudaStream_t stream) {
  const BwdPlan pl = bwd_plan(sq, sk, kStored);
  if (pl.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = fused_attention_bwd_mma_kernel<kStored, NT, P>;
  // once per instantiation, at the first launch (not inside a CUDA graph
  // capture of a later one): allow up to the 227 KB a block may use
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  // the widest copy that whole rows and the start's alignment allow
  const uintptr_t p_addr = reinterpret_cast<uintptr_t>(p_in);
  constexpr int per16 = 16 / sizeof(P);  // elements in 16 bytes
  const int p_vec = sk % per16 == 0 && p_addr % 16 == 0             ? per16
                    : sk % (per16 / 2) == 0 && p_addr % 8 == 0      ? per16 / 2
                    : per16 == 8 && sk % 2 == 0 && p_addr % 4 == 0  ? 2
                                                                    : 1;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  kernel<<<dim3(heads, batch), pl.warps * 32, pl.total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), p_in, bias, static_cast<const bf16*>(g),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sq, sk, heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, scale,
      seed, batch0, col0, threshold, keep_scale, p_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). `p_in` (stored: the forward's contiguous
// residual [B, Sq, H*Sk], fp32 or, when `p_bf16` is 1, bf16) or `bias`
// (recompute: contiguous fp32 [B, Sk]) selects the variant: exactly one of
// them is non-null. q, k, v and g are
// read through batch and row strides (elements; last dimension
// contiguous); dq [B, Sq, H*D] and dk, dv [B, Sk, H*D] are contiguous.
// `seed`, `batch0`, `col0`, `threshold` and `keep_scale` are the forward's
// dropout arguments.
int fused_attention_bwd(const void* q, const void* k, const void* v,
                        const void* p_in, const float* bias, const void* g,
                        void* dq, void* dk, void* dv, int batch, int sq,
                        int sk, int heads, int head_dim, int64_t q_sb,
                        int64_t q_ss, int64_t k_sb, int64_t k_ss,
                        int64_t v_sb, int64_t v_ss, int64_t g_sb,
                        int64_t g_ss, int is_bf16, int p_bf16, uint32_t seed,
                        uint32_t batch0, uint32_t col0, uint32_t threshold,
                        float keep_scale, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || sq < 1 ||
      sk < 1 || heads < 1 || heads * sq > kMaxHeadsTimesSeq ||
      heads * sk > kMaxHeadsTimesSeq || (p_in == nullptr) == (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the residual's type is a template parameter, so the fp32 kernels carry
  // no per-element branch on it
  const float* p32 = p_bf16 ? nullptr : static_cast<const float*>(p_in);
  const bf16* p16 = p_bf16 ? static_cast<const bf16*>(p_in) : nullptr;
#define FA_BWD_ARGS(P_IN)                                                    \
  q, k, v, P_IN, bias, g, dq, dk, dv, batch, sq, sk, heads, q_sb, q_ss,     \
      k_sb, k_ss, v_sb, v_ss, g_sb, g_ss, seed, batch0, col0, threshold,   \
      keep_scale, s
  if (is_bf16) {
    if (!fa::aligned16(q, q_sb, q_ss) || !fa::aligned16(k, k_sb, k_ss) ||
        !fa::aligned16(v, v_sb, v_ss) || !fa::aligned16(g, g_sb, g_ss))
      return (int)cudaErrorMisalignedAddress;
    if (fa::row_tiles(sk, 6) == 2)
      return p16   ? launch_mma<true, 2, bf16>(FA_BWD_ARGS(p16))
             : p32 ? launch_mma<true, 2, float>(FA_BWD_ARGS(p32))
                   : launch_mma<false, 2, float>(FA_BWD_ARGS(p32));
    return p16   ? launch_mma<true, 6, bf16>(FA_BWD_ARGS(p16))
           : p32 ? launch_mma<true, 6, float>(FA_BWD_ARGS(p32))
                 : launch_mma<false, 6, float>(FA_BWD_ARGS(p32));
  }
  if (smem_bytes(sq, sk) > kMaxSmem) return (int)cudaErrorInvalidValue;
  return p16   ? launch_typed<true, bf16>(FA_BWD_ARGS(p16))
         : p32 ? launch_typed<true, float>(FA_BWD_ARGS(p32))
               : launch_typed<false, float>(FA_BWD_ARGS(p32));
#undef FA_BWD_ARGS
}

const char* fused_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
