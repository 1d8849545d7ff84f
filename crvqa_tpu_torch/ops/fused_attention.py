"""Fused short-sequence multi-head attention — Hopper kernels.

Counterpart of `crvqa_tpu/ops/fused_attention.py`. The kernels are
`csrc/fused_attention_fwd.cu` (the primal and the forward for grad) and
`csrc/fused_attention_bwd.cu` (the stored and the recompute backward):
bf16 on the tensor cores (`mma.sync`), fp32 on scalar FMAs; see their
headers for what each replaces, its bound and its design. This module
holds their ctypes bindings, their plain PyTorch versions, and the wrappers
that choose between them by the tensor's device:

- CPU tensors take the plain versions (the tests' path), and so do `meta`
  tensors (`utils/mfu.count_flops`: there `fused_attention` is autograd of
  the plain forward, the model's work whichever backward runs);
- CUDA tensors launch the kernel or raise. There is no fallback.

Each wrapper counts its kernel launches (and nothing else) in `.launches`:
`fused_attention.launches` (primal), `fused_attention_fwd_train.launches`,
`fused_attention_bwd_stored.launches`, `fused_attention_bwd_recompute
.launches`, so a run can show that its main path went through the kernels.

`fused_attention(..., rate, seed)` is differentiable: when autograd needs
it, the forward for grad runs and `BWD_IMPL` ("stored", the default, keeps
the probability residual; "recompute" rebuilds it from q, k and the
bias) selects the backward at call time, as in the JAX package, and
`P_RESIDUAL_DTYPE` (fp32, or bf16 at half the bytes) the stored
residual's type. Dropout
uses the JAX kernels' counter-hash keep mask (`keep_mask`), a pure function
of (seed, batch row, row, lane-blocked column), so the backward regenerates
it and the port's masks equal the JAX package's bit for bit.

Scope: H*Sq <= 1024 and H*Sk <= 1024 (the JAX short-seq predicate,
models/layers.py:275), and on the card head_size 64 with fp32 or bf16
activations; bf16 q, k, v and g start 16-byte aligned with batch and row
strides of whole 16-byte units (the kernels stage them 16 bytes a thread).
The backward also needs its block's shared memory to fit
(`bwd_smem_bytes`): every shape at H >= 12, and every shape the fp32
kernel takes in bf16.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import PLAIN_DEVICES, _build

MAX_HEADS_TIMES_SEQ = 1024
KERNEL_HEAD_SIZE = 64
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_BWD_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_MMA_PITCH = KERNEL_HEAD_SIZE + 8  # a staged bf16 row: 144 bytes
_MMA_MAX_WARPS = 8

# Backward implementation, read when the forward runs: "stored" (the
# forward writes the pre-dropout probabilities as a residual) or
# "recompute" (flash-style, from q, k and the bias). "stored_folddot" is
# the JAX package's stored backward with the tiled dk / dv head blocks
# folded by one selector product on the TPU's matrix unit instead of H
# adds: the same sum. The Hopper kernel has no tiled blocks to fold (a
# block holds one head and sums its own rows), so it runs the stored one.
BWD_IMPL = "stored"
_BWD_IMPLS = ("stored", "recompute", "stored_folddot")

# Storage type of the stored backward's residual, read when the forward
# runs (`P_RESIDUAL_DTYPE` of the JAX package): torch.float32 (exact) or
# torch.bfloat16, half the residual's bytes; the backward widens it and
# does its math in fp32, so only its softmax-gradient terms see the extra
# rounding (the context product takes the unrounded p either way).
P_RESIDUAL_DTYPE = torch.float32
_P_RESIDUAL_DTYPES = (torch.float32, torch.bfloat16)

_MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------ dropout mask

def keep_threshold(rate: float) -> int:
    """P(hash >= threshold) = 1 - rate (`_keep_mask`'s uint32 threshold)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def keep_mask(batch_rows: torch.Tensor, sq: int, cols: int, rate: float,
              seed: int, head=0, col0: int = 0) -> torch.Tensor:
    """Bool keep mask [*batch_rows.shape, sq, cols] of
    `crvqa_tpu/ops/fused_attention.py:_keep_mask`: keyed on (seed as
    uint32, global batch row, head argument, row i, column col0 + j). This
    module's kernels pass head 0 and the lane-blocked column h*Sk + k
    (`col0` = head0 * Sk for a rank holding heads head0..); the mid-length
    kernel passes the absolute head (an int or an int64 tensor
    broadcastable against `batch_rows`) and the plain key index. uint32
    arithmetic in int64 with explicit wrap-around."""
    dev = batch_rows.device
    seed_u = seed & _MASK32
    key = (((seed_u * 2654435761) & _MASK32)
           + batch_rows.to(torch.int64) * 97531
           + ((head * 1000003) & _MASK32)) & _MASK32
    i = torch.arange(sq, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(col0, col0 + cols, dtype=torch.int64, device=dev)[None, :]
    x = (i * 374761393 + j * 668265263) & _MASK32            # [sq, cols]
    x = (x + key[..., None, None]) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 1274126177) & _MASK32
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def _drop_factor(b: int, sq: int, num_heads: int, sk: int, rate: float,
                 seed: int, device, row0: int = 0, head0: int = 0
                 ) -> torch.Tensor:
    """[B, H, Sq, Sk] fp32: 1/(1-rate) where kept, 0 where dropped (1 at
    rate 0). `row0` / `head0`: the global batch row and head of the
    slice's first (a data- or tensor-parallel rank's rows and heads), so
    that a rank draws its part of the whole batch's mask."""
    if rate == 0.0:
        return torch.ones((), device=device)
    keep = keep_mask(torch.arange(row0, row0 + b, device=device), sq,
                     num_heads * sk, rate, seed, col0=head0 * sk)
    keep = keep.reshape(b, sq, num_heads, sk).transpose(1, 2)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).float()


# ---------------------------------------------------------- plain versions

def _split(t: torch.Tensor, num_heads: int, head_size: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, num_heads, head_size).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _probs(q, k, bias, num_heads, head_size):
    """fp32 per-head softmax(q k^T / sqrt(D) + bias): [B, H, Sq, Sk]."""
    s = torch.matmul(_split(q, num_heads, head_size).float(),
                     _split(k, num_heads, head_size).float().transpose(-1, -2))
    s = s / math.sqrt(head_size) + bias.float()[:, None, None, :]
    return torch.softmax(s, dim=-1)


def probs_residual(q, k, bias, num_heads: int, head_size: int
                   ) -> torch.Tensor:
    """The plain pre-dropout probabilities in the residual layout
    [B, Sq, H*Sk] fp32 (column h*Sk + k): what the recompute backward
    rebuilds."""
    b, sq, _ = q.shape
    p = _probs(q, k, bias, num_heads, head_size)
    return p.transpose(1, 2).reshape(b, sq, num_heads * k.shape[1])


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              num_heads: int, head_size: int) -> torch.Tensor:
    """Plain PyTorch version, the math of the JAX package's
    `reference_attention`: per head softmax(q k^T / sqrt(D) + bias) @ v.
    Scores and softmax in fp32 (as the kernel computes them), p cast to the
    activation dtype before the context product.

    q [B, Sq, H*D]; k, v [B, Sk, H*D]; bias [B, Sk] additive fp32."""
    p = _probs(q, k, bias, num_heads, head_size)
    ctx = torch.matmul(p.to(q.dtype), _split(v, num_heads, head_size))
    return _merge(ctx)


def fused_attention_train_reference(q, k, v, bias, num_heads: int,
                                    head_size: int, rate: float, seed: int,
                                    row0: int = 0, head0: int = 0
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward for grad: (out, p) with p the
    pre-dropout probabilities in the residual layout [B, Sq, H*Sk]
    (column h*Sk + k), fp32 rounded to `P_RESIDUAL_DTYPE`, and dropout
    applied from `keep_mask` to the unrounded p before it is rounded to
    the activation dtype (crvqa_tpu/ops/fused_attention.py:205-211).
    Differentiable by autograd."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    p = _probs(q, k, bias, num_heads, head_size)
    pd = p * _drop_factor(b, sq, num_heads, sk, rate, seed, q.device, row0,
                          head0)
    ctx = torch.matmul(pd.to(q.dtype), _split(v, num_heads, head_size))
    res = p.transpose(1, 2).reshape(b, sq, num_heads * sk)
    return _merge(ctx), res.to(_residual_dtype())


def fused_attention_bwd_reference(q, k, v, p, g, num_heads: int,
                                  head_size: int, rate: float, seed: int,
                                  row0: int = 0, head0: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The backward step by step, with the TPU kernel's rounding points
    (`_bwd_kernel_stored`, crvqa_tpu/ops/fused_attention.py:536-566): p is
    the residual [B, Sq, H*Sk] (fp32 or bf16, widened to fp32); returns
    (dq, dk, dv) in q's dtype."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    dt = q.dtype
    ph = p.float().reshape(b, sq, num_heads, sk).transpose(1, 2)
    drop = _drop_factor(b, sq, num_heads, sk, rate, seed, q.device, row0,
                        head0)
    gh = _split(g.to(dt), num_heads, head_size)
    qh, kh, vh = (_split(t, num_heads, head_size) for t in (q, k, v))
    p_t = ph * drop
    dv = torch.matmul(p_t.to(dt).float().transpose(-1, -2), gh.float())
    dp = torch.matmul(gh.float(), vh.float().transpose(-1, -2)) * drop
    blocksum = (dp * ph).sum(-1, keepdim=True)
    ds = ((dp - blocksum) * ph * (1.0 / math.sqrt(head_size))).to(dt).float()
    dq = torch.matmul(ds, kh.float())
    dk = torch.matmul(ds.transpose(-1, -2), qh.float())
    return _merge(dq).to(dt), _merge(dk).to(dt), _merge(dv).to(dt)


# ---------------------------------------------------------------- wrappers

def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, num_heads: int, head_size: int,
                    rate: float = 0.0, seed: int = 0, row0: int = 0,
                    head0: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) (dropout) @ v per head, in the
    projection layout: q [B, Sq, H*D], k and v [B, Sk, H*D], bias [B, Sk]
    fp32 (0 for live keys, -10000 for padding). Returns [B, Sq, H*D] in q's
    dtype. `seed` (int32 range) keys the dropout mask; it is unused at rate
    0. `row0` / `head0` place these rows and heads in a larger batch (a
    data-parallel rank's first global row, a tensor-parallel rank's first
    head): the mask is that batch's slice. Differentiable in q, k and v
    (`FusedAttentionFunction`)."""
    _check_shapes(q, k, v, bias, num_heads, head_size)
    _check_rate(rate)
    if q.device.type == "meta":
        # the model's work for `utils/mfu.count_flops`: autograd of the
        # plain forward, whichever backward `BWD_IMPL` runs on the card
        return fused_attention_train_reference(
            q, k, v, bias, num_heads, head_size, rate, seed, row0, head0)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttentionFunction.apply(q, k, v, bias, num_heads,
                                            head_size, rate, seed, row0,
                                            head0)
    if rate != 0.0:
        return fused_attention_fwd_train(q, k, v, bias, num_heads, head_size,
                                         rate, seed, residual=False,
                                         row0=row0, head0=head0)[0]
    if q.device.type in PLAIN_DEVICES:
        return fused_attention_reference(q, k, v, bias, num_heads, head_size)
    _check_cuda(q, k, v, bias, head_size)
    return _launch_primal(q, k, v, bias, num_heads, head_size)


fused_attention.launches = 0


def fused_attention_fwd_train(q, k, v, bias, num_heads: int, head_size: int,
                              rate: float, seed: int, residual: bool = True,
                              row0: int = 0, head0: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward for grad: (out, p residual [B, Sq, H*Sk] in
    `P_RESIDUAL_DTYPE`, read now, or None when `residual` is False)."""
    _check_shapes(q, k, v, bias, num_heads, head_size)
    _check_rate(rate)
    if q.device.type in PLAIN_DEVICES:
        out, p = fused_attention_train_reference(q, k, v, bias, num_heads,
                                                 head_size, rate, seed, row0,
                                                 head0)
        return out, (p if residual else None)
    _check_cuda(q, k, v, bias, head_size)
    return _launch_fwd_train(q, k, v, bias, num_heads, head_size, rate, seed,
                             residual, row0, head0, _residual_dtype())


fused_attention_fwd_train.launches = 0


def fused_attention_bwd_stored(q, k, v, p, g, num_heads: int, head_size: int,
                               rate: float, seed: int, row0: int = 0,
                               head0: int = 0):
    """dq, dk, dv from the stored residual p [B, Sq, H*Sk]: fp32 or bf16,
    whichever the forward wrote (`P_RESIDUAL_DTYPE` decides only that)."""
    if q.device.type in PLAIN_DEVICES:
        return fused_attention_bwd_reference(q, k, v, p, g, num_heads,
                                             head_size, rate, seed, row0,
                                             head0)
    if p.dtype not in _P_RESIDUAL_DTYPES or not p.is_contiguous():
        raise TypeError(f"fused_attention backward kernel: the residual must "
                        f"be a contiguous [B, Sq, H*Sk] tensor of one of "
                        f"{_P_RESIDUAL_DTYPES}, got {p.dtype}")
    out = _launch_bwd(q, k, v, p, None, g, num_heads, head_size, rate, seed,
                      row0, head0)
    fused_attention_bwd_stored.launches += 1
    return out


fused_attention_bwd_stored.launches = 0


def fused_attention_bwd_recompute(q, k, v, bias, g, num_heads: int,
                                  head_size: int, rate: float, seed: int,
                                  row0: int = 0, head0: int = 0):
    """dq, dk, dv with p rebuilt from q, k and the bias."""
    if q.device.type in PLAIN_DEVICES:
        p = probs_residual(q, k, bias, num_heads, head_size)
        return fused_attention_bwd_reference(q, k, v, p, g, num_heads,
                                             head_size, rate, seed, row0,
                                             head0)
    out = _launch_bwd(q, k, v, None, bias, g, num_heads, head_size, rate,
                      seed, row0, head0)
    fused_attention_bwd_recompute.launches += 1
    return out


fused_attention_bwd_recompute.launches = 0


class FusedAttentionFunction(torch.autograd.Function):
    """Forward for grad + backward kernel (`_fas_fwd` / `_fas_bwd` of the
    JAX package). Saves (q, k, v, p) for the stored backward or (q, k, v,
    bias) for the recompute one; seed, rate and the offsets ride as
    non-tensor state. The bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, head_size, rate, seed,
                row0=0, head0=0):
        impl = BWD_IMPL
        if impl not in _BWD_IMPLS:
            raise ValueError(f"fused_attention: BWD_IMPL {impl!r} is not one "
                             f"of {_BWD_IMPLS}")
        stored = impl != "recompute"
        out, p = fused_attention_fwd_train(q, k, v, bias, num_heads,
                                           head_size, rate, seed,
                                           residual=stored, row0=row0,
                                           head0=head0)
        ctx.save_for_backward(q, k, v, p if stored else bias)
        ctx.impl = "stored" if stored else impl
        ctx.args = (num_heads, head_size, rate, seed, row0, head0)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, saved = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        fn = (fused_attention_bwd_stored if ctx.impl == "stored"
              else fused_attention_bwd_recompute)
        dq, dk, dv = fn(q, k, v, saved, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


# ------------------------------------------------------------------ checks

def _check_shapes(q, k, v, bias, num_heads, head_size):
    """Shapes and devices of q, k, v and (unless None) the bias."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or (
            bias is not None and bias.dim() != 2):
        raise ValueError("fused_attention: q/k/v must be [B, S, H*D] and "
                         "bias [B, Sk]")
    b, sq, d = q.shape
    sk = k.shape[1]
    if d != num_heads * head_size:
        raise ValueError(f"fused_attention: width {d} != {num_heads} heads "
                         f"x {head_size}")
    if (k.shape != (b, sk, d) or v.shape != (b, sk, d)
            or (bias is not None and bias.shape != (b, sk))):
        raise ValueError(
            f"fused_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)} do not agree")
    if (num_heads * sq > MAX_HEADS_TIMES_SEQ
            or num_heads * sk > MAX_HEADS_TIMES_SEQ):
        raise ValueError(
            f"fused_attention: H*Sq = {num_heads * sq}, H*Sk = "
            f"{num_heads * sk}; the short-sequence scope is <= "
            f"{MAX_HEADS_TIMES_SEQ}")
    if len({t.device for t in (q, k, v, bias) if t is not None}) != 1:
        raise ValueError("fused_attention: q, k, v and bias must share a "
                         "device")


def _residual_dtype() -> torch.dtype:
    """`P_RESIDUAL_DTYPE`; raises on anything but fp32 and bf16."""
    if P_RESIDUAL_DTYPE not in _P_RESIDUAL_DTYPES:
        raise ValueError(f"fused_attention: residual dtype "
                         f"{P_RESIDUAL_DTYPE} is not one of "
                         f"{_P_RESIDUAL_DTYPES}")
    return P_RESIDUAL_DTYPE


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_attention: dropout rate {rate} not in [0, 1)")


def bwd_smem_bytes(sq: int, sk: int, dtype: torch.dtype, stored: bool
                   ) -> int:
    """Shared memory of the backward kernel's block at (Sq, Sk).

    fp32 (scalar): q, g, k, v at a pitch of D + 1 floats and three fp32
    [Sq, Sk] planes. bf16 (tensor cores; `BwdPlan` in the source): q, g
    and k as bf16 rows of 144 bytes padded to whole 16-row tiles, the ds
    and p_t planes [Sq, Sk + 8] bf16, then V and the stored p plane (or the
    recompute bias), which the product phase reuses as one 2304-byte output
    slot per warp."""
    if dtype != torch.bfloat16:
        return 4 * ((2 * sq + 2 * sk) * (KERNEL_HEAD_SIZE + 1) + 3 * sq * sk)
    sqp, skp = 16 * -(-sq // 16), 16 * -(-sk // 16)
    row, plane = 2 * _MMA_PITCH, 2 * sqp * (skp + 8)
    warps = min(max(sqp, skp) // 16, _MMA_MAX_WARPS)
    tail = row * skp + (2 * plane if stored else 4 * skp)
    return row * (2 * sqp + skp) + 2 * plane + max(tail, 16 * row * warps)


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """Batch and row strides as the kernels take them: 0 for a dimension of
    size 1, whose stride is never used and may be anything."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in (0, 1))


def _tiles_aligned(t: torch.Tensor) -> bool:
    """What the bf16 kernels' 16-byte cp.async staging needs: a 16-byte
    aligned start and batch and row strides of whole 16-byte units."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _strides(t))


def _check_aligned(*operands):
    if operands[0].dtype == torch.bfloat16 and not all(
            _tiles_aligned(t) for t in operands):
        raise ValueError("fused_attention bf16 kernel: q/k/v/g must start "
                         "16-byte aligned with batch and row strides that "
                         "are multiples of 8 elements")


def _check_cuda(q, k, v, bias, head_size, g=None):
    """What the kernels take (bias None: the stored backward, which reads
    none; with `g`, the backward's cotangent too); raises on anything
    else."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention kernel: q/k/v must share fp32 or "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise TypeError("fused_attention kernel: bias must be a contiguous "
                        "fp32 [B, Sk] tensor")
    if head_size != KERNEL_HEAD_SIZE:
        raise ValueError(f"fused_attention kernel: head_size {head_size} "
                         f"(the kernel takes {KERNEL_HEAD_SIZE})")
    if g is not None and (g.shape != q.shape or g.dtype != q.dtype):
        raise TypeError("fused_attention backward kernel: g must match q's "
                        "shape and dtype")
    operands = (q, k, v) if g is None else (q, k, v, g)
    if any(t.stride(2) != 1 for t in operands):
        raise ValueError("fused_attention kernel: the H*D dimension of "
                         "q/k/v/g must be contiguous")
    _check_aligned(*operands)


# ---------------------------------------------------------------- launches

_p, _i, _i64, _u32, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_uint32, ctypes.c_float)


def _fwd_library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("fused_attention_fwd")
    if lib.fused_attention_fwd.argtypes is None:
        lib.fused_attention_fwd.argtypes = [
            _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
            _i64, _i64, _i64, _i64, _i64, _i64, _i, _p]
        lib.fused_attention_fwd.restype = ctypes.c_int
        lib.fused_attention_fwd_train.argtypes = [
            _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
            _i64, _i64, _i64, _i64, _i64, _i64, _i, _i, _u32, _u32, _u32,
            _u32, _f32, _p]
        lib.fused_attention_fwd_train.restype = ctypes.c_int
        lib.fused_attention_fwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("fused_attention_bwd")
    if lib.fused_attention_bwd.argtypes is None:
        lib.fused_attention_bwd.argtypes = [
            _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i, _i,
            _u32, _u32, _u32, _u32, _f32, _p]
        lib.fused_attention_bwd.restype = ctypes.c_int
        lib.fused_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _dropout_args(rate: float, seed: int) -> tuple[int, int, float]:
    """(seed bits, threshold, keep scale) as the kernels take them."""
    _check_rate(rate)
    return seed & _MASK32, keep_threshold(rate), 1.0 / (1.0 - rate)


def _launch_primal(q, k, v, bias, num_heads, head_size):
    b, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, d), dtype=q.dtype, device=q.device)
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        rc = lib.fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, sq, sk, num_heads, head_size,
            *_strides(q), *_strides(k), *_strides(v),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "fused_attention_fwd")
    fused_attention.launches += 1
    return out


def _offsets(row0: int, head0: int, sk: int) -> tuple[int, int]:
    """(batch0, col0) as the kernels take them: the first global batch row
    and lane-blocked column (head0 * Sk), as uint32."""
    if row0 < 0 or head0 < 0:
        raise ValueError(f"fused_attention: offsets row0 {row0}, head0 "
                         f"{head0} must be >= 0")
    return row0 & _MASK32, (head0 * sk) & _MASK32


def _launch_fwd_train(q, k, v, bias, num_heads, head_size, rate, seed,
                      residual, row0, head0, p_dtype):
    b, sq, d = q.shape
    sk = k.shape[1]
    seed_u, threshold, keep_scale = _dropout_args(rate, seed)
    out = torch.empty((b, sq, d), dtype=q.dtype, device=q.device)
    p = (torch.empty((b, sq, num_heads * sk), dtype=p_dtype,
                     device=q.device) if residual else None)
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        rc = lib.fused_attention_fwd_train(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if p is None else p.data_ptr(),
            b, sq, sk, num_heads, head_size,
            *_strides(q), *_strides(k), *_strides(v),
            int(q.dtype == torch.bfloat16), int(p_dtype == torch.bfloat16),
            seed_u, *_offsets(row0, head0, sk), threshold, keep_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "fused_attention_fwd")
    fused_attention_fwd_train.launches += 1
    return out, p


def _launch_bwd(q, k, v, p, bias, g, num_heads, head_size, rate, seed,
                row0=0, head0=0):
    """The backward kernel, stored (p given) or recompute (bias given)."""
    _check_shapes(q, k, v, bias, num_heads, head_size)
    _check_cuda(q, k, v, bias, head_size, g)
    b, sq, d = q.shape
    sk = k.shape[1]
    if p is not None and p.shape != (b, sq, num_heads * sk):
        raise ValueError(f"fused_attention backward kernel: residual shape "
                         f"{tuple(p.shape)} != {(b, sq, num_heads * sk)}")
    smem = bwd_smem_bytes(sq, sk, q.dtype, p is not None)
    if smem > _BWD_SMEM_LIMIT:
        raise ValueError(f"fused_attention backward kernel: (Sq, Sk) = "
                         f"({sq}, {sk}) needs {smem} bytes of shared memory, "
                         f"over the {_BWD_SMEM_LIMIT} a block may use")
    seed_u, threshold, keep_scale = _dropout_args(rate, seed)
    dq = torch.empty((b, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, d), dtype=q.dtype, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        rc = lib.fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if p is None else p.data_ptr(),
            None if bias is None else bias.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, num_heads, head_size,
            *_strides(q), *_strides(k), *_strides(v), *_strides(g),
            int(q.dtype == torch.bfloat16),
            int(p is not None and p.dtype == torch.bfloat16), seed_u,
            *_offsets(row0, head0, sk), threshold, keep_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "fused_attention_bwd")
    return dq, dk, dv
