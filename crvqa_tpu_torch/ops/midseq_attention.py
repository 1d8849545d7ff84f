"""Mid-length multi-head attention — the Hopper kernel's binding.

Counterpart of `crvqa_tpu/ops/midseq_attention.py`: the attentions out of
the short kernel's H*S <= 1024 scope (mPLUG's 577-patch ViT self-attention,
the fusion encoder's text->image cross-attention, the stride layer's joint
attention, the decoder's grouped cross-attention). The kernels are
`csrc/midseq_attention_fwd.cu` and `csrc/midseq_attention_bwd.cu` (the
recompute backward); see their headers for what each replaces, its bound
and its design. This module holds their ctypes bindings, their plain
PyTorch versions and the wrappers that choose between them by the tensor's
device:

- CPU tensors take the plain forward (the tests' path), differentiable by
  autograd;
- CUDA tensors launch the kernels or raise. There is no fallback.

`midseq_attention.launches` and `midseq_attention_bwd.launches` count the
kernels' launches and nothing else.

bf16 runs on the tensor cores (`csrc/midseq_mma_common.cuh`): no Sk bound,
but q, k, v (and g) must start 16-byte aligned with row and batch strides
that are multiples of 8 elements, since K, V, Q and G tiles are staged 16
bytes a thread. fp32 runs on the scalar kernels, whose shared-memory rows
of Sk probabilities bound Sk (`smem_bytes`, `bwd_smem_bytes`).

`midseq_attention` is differentiable in q, k and v: on a CUDA tensor that
needs a gradient `MidseqAttentionFunction` launches the forward kernel,
saves q, k, v, the bias and the seed only (`_ms_fwd` of the JAX module), and
its backward launches the backward kernel, which rebuilds the probabilities
and the dropout mask.

Dropout uses the JAX kernel's counter-hash keep mask keyed on the ABSOLUTE
head index and the plain key index (`fused_attention.keep_mask` with a head
argument): the port's masks equal the JAX package's bit for bit.

`supported()` and `_pick_hg()` are copies of the JAX module's: the model
dispatch asks the same question of the same shapes, so both packages send
the same attentions to this kernel (`_pick_hg` only aligns TPU lanes; it
enters the dispatch through the TPU's VMEM budget).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .fused_attention import (KERNEL_HEAD_SIZE, _dropout_args, _merge,
                              _probs, _split, keep_mask)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_ROWS, _KEY_TILE = 16, 32  # the fp32 kernel's rows per block, keys per tile

# The JAX module's per-program VMEM budget (bytes): its dispatch predicate.
_VMEM_BUDGET = 12 * 1024 * 1024


# -------------------------------------------- the JAX dispatch predicate

def _pick_hg(num_heads: int, head_size: int) -> int:
    """Heads per TPU program: the smallest divisor of H whose lane width
    hg*D is 128-aligned, else all heads (`_pick_hg` of the JAX module)."""
    for hg in range(1, num_heads):
        if num_heads % hg == 0 and (hg * head_size) % 128 == 0:
            return hg
    return num_heads


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def supported(batch: int, sq: int, sk: int, num_heads: int, head_size: int,
              itemsize: int) -> bool:
    """The JAX module's dispatch predicate: True iff its recompute backward
    fits the TPU's VMEM budget at these shapes (Sq padded to 16, Sk to 128,
    double-buffered io blocks of hg heads plus four fp32 [Sqp, Skp]
    planes). The model dispatch sends the mid-length attentions it admits
    to this kernel and the rest to the eager path."""
    if batch < 1 or sq < 1 or sk < 1:
        return False
    w = _pick_hg(num_heads, head_size) * head_size
    sqp, skp = _pad_to(sq, 16), _pad_to(sk, 128)
    io = (3 * sqp * w + 4 * skp * w) * itemsize + skp * 4
    return 2 * io + 4 * sqp * skp * 4 <= _VMEM_BUDGET


# ----------------------------------------------------------- plain version

def drop_factor(b: int, num_heads: int, sq: int, sk: int, rate: float,
                seed: int, device, row0: int = 0, head0: int = 0
                ) -> torch.Tensor:
    """[B, H, Sq, Sk] fp32: 1/(1-rate) where kept, 0 where dropped (1 at
    rate 0), the mask keyed on (global row row0 + b, absolute head
    head0 + h, row i, key j): a data- or tensor-parallel rank draws its
    slice of the whole batch's mask."""
    if rate == 0.0:
        return torch.ones((), device=device)
    rows = torch.arange(row0, row0 + b, dtype=torch.int64,
                        device=device)[:, None]
    heads = torch.arange(head0, head0 + num_heads, dtype=torch.int64,
                         device=device)[None]
    keep = keep_mask(rows, sq, sk, rate, seed, head=heads)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).float()


def midseq_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               num_heads: int, head_size: int,
                               rate: float = 0.0, seed: int = 0,
                               row0: int = 0, head0: int = 0
                               ) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's forward, step by step: fp32
    scores and full-row softmax, dropout from the counter-hash mask, p
    rounded to the activation dtype before the context product.
    Differentiable by autograd.

    q [B, Sq, H*D]; k, v [B, Sk, H*D]; bias [B, Sk] additive fp32."""
    b, sq, _ = q.shape
    p = _probs(q, k, bias, num_heads, head_size)
    p = p * drop_factor(b, num_heads, sq, k.shape[1], rate, seed, q.device,
                        row0, head0)
    ctx = torch.matmul(p.to(q.dtype), _split(v, num_heads, head_size))
    return _merge(ctx)


# ----------------------------------------------------------------- wrapper

def midseq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, num_heads: int, head_size: int,
                     rate: float = 0.0, seed: int = 0, row0: int = 0,
                     head0: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) (dropout) @ v per head, in the
    projection layout: q [B, Sq, H*D], k and v [B, Sk, H*D], bias [B, Sk]
    fp32 (0 for live keys, -10000 for padding). Returns [B, Sq, H*D] in q's
    dtype. `seed` (int32 range) keys the dropout mask; unused at rate 0.
    `row0` / `head0`: the global batch row and head of this slice's first
    (a data- or tensor-parallel rank's)."""
    _check_shapes(q, k, v, bias, num_heads, head_size)
    _dropout_args(rate, seed)  # validates the rate
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type == "cpu":
        return midseq_attention_reference(q, k, v, bias, num_heads,
                                          head_size, rate, seed, row0, head0)
    _check_cuda(q, k, v, bias, head_size)
    if needs_grad:
        return MidseqAttentionFunction.apply(q, k, v, bias, num_heads,
                                             head_size, rate, seed, row0,
                                             head0)
    return _launch(q, k, v, bias, num_heads, head_size, rate, seed, row0,
                   head0)


midseq_attention.launches = 0


def midseq_attention_bwd_reference(q, k, v, bias, g, num_heads: int,
                                   head_size: int, rate: float = 0.0,
                                   seed: int = 0, row0: int = 0,
                                   head0: int = 0
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain PyTorch version of the TPU kernel's recompute backward, step
    by step with its rounding points (`_bwd_kernel` and `_ms_bwd`,
    crvqa_tpu/ops/midseq_attention.py:133-183, 264-280): g cast to q's dtype
    first; p rebuilt in fp32; p * drop rounded to the activation dtype
    before the dv product; dp and its row sum in fp32 with the dropout
    factor inside dp; ds rounded before the dq and dk products; fp32
    accumulation, outputs rounded once. Returns (dq, dk, dv) in q's dtype."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    dt = q.dtype
    p = _probs(q, k, bias, num_heads, head_size)
    drop = drop_factor(b, num_heads, sq, sk, rate, seed, q.device, row0,
                       head0)
    gh = _split(g.to(dt), num_heads, head_size).float()
    qh, kh, vh = (_split(t, num_heads, head_size).float() for t in (q, k, v))
    dv = torch.matmul((p * drop).to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2)) * drop
    rowsum = (dp * p).sum(-1, keepdim=True)
    ds = ((dp - rowsum) * p * (1.0 / math.sqrt(head_size))).to(dt).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return _merge(dq).to(dt), _merge(dk).to(dt), _merge(dv).to(dt)


def midseq_attention_bwd(q, k, v, bias, g, num_heads: int, head_size: int,
                         rate: float = 0.0, seed: int = 0, row0: int = 0,
                         head0: int = 0):
    """(dq, dk, dv) of `midseq_attention` for the output cotangent g
    [B, Sq, H*D], recomputed from q, k, v, the bias and the seed. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_shapes(q, k, v, bias, num_heads, head_size)
    _dropout_args(rate, seed)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"midseq_attention_bwd: g {tuple(g.shape)} on "
                         f"{g.device} does not match q {tuple(q.shape)} on "
                         f"{q.device}")
    if q.device.type == "cpu":
        return midseq_attention_bwd_reference(q, k, v, bias, g, num_heads,
                                              head_size, rate, seed, row0,
                                              head0)
    _check_cuda(q, k, v, bias, head_size, g)
    return _launch_bwd(q, k, v, bias, g, num_heads, head_size, rate, seed,
                       row0, head0)


midseq_attention_bwd.launches = 0


class MidseqAttentionFunction(torch.autograd.Function):
    """Forward kernel + recompute backward kernel (`_ms_fwd` / `_ms_bwd` of
    the JAX module): saves q, k, v and the bias; seed and rate ride as
    non-tensor state. The bias and the seed get no gradient. Applied to CPU
    tensors (the tests do; the wrapper leaves those to autograd) both
    halves take their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, head_size, rate, seed,
                row0=0, head0=0):
        forward = (midseq_attention_reference if q.device.type == "cpu"
                   else _launch)
        out = forward(q, k, v, bias, num_heads, head_size, rate, seed, row0,
                      head0)
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (num_heads, head_size, rate, seed, row0, head0)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = midseq_attention_bwd(q, k, v, bias,
                                          g.to(q.dtype).contiguous(),
                                          *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


# ------------------------------------------------------------------ checks

def _check_shapes(q, k, v, bias, num_heads, head_size):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 2:
        raise ValueError("midseq_attention: q/k/v must be [B, S, H*D] and "
                         "bias [B, Sk]")
    b, _, d = q.shape
    sk = k.shape[1]
    if d != num_heads * head_size:
        raise ValueError(f"midseq_attention: width {d} != {num_heads} heads "
                         f"x {head_size}")
    if k.shape != (b, sk, d) or v.shape != (b, sk, d) or bias.shape != (b, sk):
        raise ValueError(
            f"midseq_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, bias {tuple(bias.shape)} "
            "do not agree")
    if len({t.device for t in (q, k, v, bias)}) != 1:
        raise ValueError("midseq_attention: q, k, v and bias must share a "
                         "device")


def smem_bytes(sk: int) -> int:
    """Shared memory the fp32 kernel's block needs at Sk keys: a staged key
    tile (pitch D + 1), the block's q rows and one fp32 probability row of
    Sk per query row. The bf16 kernel's is fixed (two stages of K and V
    tiles) and does not grow with Sk."""
    return 4 * (_KEY_TILE * (KERNEL_HEAD_SIZE + 1)
                + _ROWS * KERNEL_HEAD_SIZE + _ROWS * sk)


def bwd_smem_bytes(sk: int) -> int:
    """Shared memory of the fp32 backward's dq block at Sk keys: a staged
    tile, the block's q and g rows, and two fp32 planes (p; dp, then ds) of
    Sk per query row. The bf16 backward's does not grow with Sk."""
    return 4 * (_KEY_TILE * (KERNEL_HEAD_SIZE + 1)
                + 2 * _ROWS * KERNEL_HEAD_SIZE + 2 * _ROWS * sk)


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """Batch and row strides as the kernels take them: 0 for a dimension of
    size 1, whose stride is never used and may be anything."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in (0, 1))


def _tiles_aligned(t: torch.Tensor) -> bool:
    """What the bf16 kernels' 16-byte cp.async staging needs: a 16-byte
    aligned start and batch and row strides of whole 16-byte units."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _strides(t))


def _check_kernel_args(q, k, v, bias, head_size, g=None):
    """What the kernels take, on any device; raises on anything else. With
    `g`, the backward's cotangent and limits too."""
    if (q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"midseq_attention kernel: q/k/v must share fp32 or "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        raise TypeError("midseq_attention kernel: bias must be a contiguous "
                        "fp32 [B, Sk] tensor")
    if head_size != KERNEL_HEAD_SIZE:
        raise ValueError(f"midseq_attention kernel: head_size {head_size} "
                         f"(the kernel takes {KERNEL_HEAD_SIZE})")
    operands = (q, k, v) if g is None else (q, k, v, g)
    if g is not None and (g.dtype != q.dtype or g.stride(2) != 1):
        raise TypeError("midseq_attention backward kernel: g must have q's "
                        "dtype and a contiguous last dimension")
    if any(t.stride(2) != 1 for t in operands):
        raise ValueError("midseq_attention kernel: the H*D dimension of "
                         "q/k/v must be contiguous")
    sk = k.shape[1]
    if q.dtype == torch.bfloat16:
        if not all(_tiles_aligned(t) for t in operands):
            raise ValueError("midseq_attention bf16 kernel: q/k/v/g must "
                             "start 16-byte aligned with batch and row "
                             "strides that are multiples of 8 elements")
    elif g is None and smem_bytes(sk) > _SMEM_LIMIT:
        raise ValueError(f"midseq_attention kernel: Sk = {sk} needs "
                         f"{smem_bytes(sk)} bytes of shared memory for its "
                         f"fp32 probability rows, over the {_SMEM_LIMIT} a "
                         "block may use")
    elif g is not None and bwd_smem_bytes(sk) > _SMEM_LIMIT:
        raise ValueError(f"midseq_attention backward kernel: Sk = {sk} needs "
                         f"{bwd_smem_bytes(sk)} bytes of shared memory for "
                         f"its two fp32 planes, over the {_SMEM_LIMIT} a "
                         "block may use")


def _check_cuda(q, k, v, bias, head_size, g=None):
    """CUDA tensors the kernels take (with `g`, the backward's); raises on
    anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"midseq_attention: unsupported device {q.device}")
    _check_kernel_args(q, k, v, bias, head_size, g)


# ------------------------------------------------------------------ launch

_p, _i, _i64, _u32, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_uint32, ctypes.c_float)


def _library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("midseq_attention_fwd")
    if lib.midseq_attention_fwd.argtypes is None:
        lib.midseq_attention_fwd.argtypes = [
            _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
            _i64, _i64, _i64, _i64, _i64, _i64, _i, _u32, _u32, _u32, _u32,
            _f32, _p]
        lib.midseq_attention_fwd.restype = ctypes.c_int
        lib.midseq_attention_fwd_error_string.argtypes = [ctypes.c_int]
        lib.midseq_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _offsets(row0: int, head0: int) -> tuple[int, int]:
    """(batch0, head0) as the kernels take them, uint32."""
    if row0 < 0 or head0 < 0:
        raise ValueError(f"midseq_attention: offsets row0 {row0}, head0 "
                         f"{head0} must be >= 0")
    return row0 & 0xFFFFFFFF, head0 & 0xFFFFFFFF


def _launch(q, k, v, bias, num_heads, head_size, rate, seed, row0=0,
            head0=0):
    b, sq, d = q.shape
    sk = k.shape[1]
    seed_u, threshold, keep_scale = _dropout_args(rate, seed)
    out = torch.empty((b, sq, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.midseq_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, sq, sk, num_heads, head_size,
            *_strides(q), *_strides(k), *_strides(v),
            int(q.dtype == torch.bfloat16),
            seed_u, *_offsets(row0, head0), threshold, keep_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.midseq_attention_fwd_error_string(rc).decode()
        raise RuntimeError(f"midseq_attention_fwd kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    midseq_attention.launches += 1
    return out


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("midseq_attention_bwd")
    if lib.midseq_attention_bwd.argtypes is None:
        lib.midseq_attention_bwd.argtypes = [
            _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i,
            _u32, _u32, _u32, _u32, _f32, _p]
        lib.midseq_attention_bwd.restype = ctypes.c_int
        lib.midseq_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.midseq_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch_bwd(q, k, v, bias, g, num_heads, head_size, rate, seed, row0=0,
                head0=0):
    b, sq, d = q.shape
    sk = k.shape[1]
    seed_u, threshold, keep_scale = _dropout_args(rate, seed)
    dq = torch.empty((b, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, d), dtype=q.dtype, device=q.device)
    # each query row's softmax max, denominator (bf16: its reciprocal) and
    # sum of dp * p: written by the dq kernel, read by the dk / dv kernel
    stats = torch.empty((b, num_heads, 3, sq), dtype=torch.float32,
                        device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        rc = lib.midseq_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), b, sq, sk, num_heads, head_size,
            *_strides(q), *_strides(k), *_strides(v), *_strides(g),
            int(q.dtype == torch.bfloat16), seed_u,
            *_offsets(row0, head0), threshold, keep_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.midseq_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"midseq_attention_bwd kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    midseq_attention_bwd.launches += 1
    return dq, dk, dv
