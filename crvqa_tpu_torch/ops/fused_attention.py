"""Fused short-sequence multi-head attention (forward) — Hopper kernel.

Counterpart of `crvqa_tpu/ops/fused_attention.py`. The kernel is
`csrc/fused_attention_fwd.cu` (see its header for what it replaces, its
bound and its design); this module holds its ctypes binding, its plain
PyTorch version, and the wrapper that chooses between them by the tensor's
device:

- CPU tensors take `fused_attention_reference` (the tests' path);
- CUDA tensors launch the kernel or raise. There is no fallback.

`fused_attention.launches` counts kernel launches (and nothing else), so a
run can show that its main path went through the kernel.

Scope: dropout rate 0 (the serving path; dropout arrives with the backward
in the training slice), H*Sq <= 1024 and H*Sk <= 1024 (the JAX short-seq
predicate, models/layers.py:275), and on the card head_size 64 with fp32 or
bf16 activations.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MAX_HEADS_TIMES_SEQ = 1024
KERNEL_HEAD_SIZE = 64
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              num_heads: int, head_size: int) -> torch.Tensor:
    """Plain PyTorch version, the math of the JAX package's
    `reference_attention`: per head softmax(q k^T / sqrt(D) + bias) @ v.
    Scores and softmax in fp32 (as the kernel computes them), p cast to the
    activation dtype before the context product.

    q [B, Sq, H*D]; k, v [B, Sk, H*D]; bias [B, Sk] additive fp32."""
    b, sq, d = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, sq, num_heads, head_size).transpose(1, 2)
    kh = k.reshape(b, sk, num_heads, head_size).transpose(1, 2)
    vh = v.reshape(b, sk, num_heads, head_size).transpose(1, 2)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    s = s / math.sqrt(head_size) + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    ctx = torch.matmul(p.to(q.dtype), vh)                 # [B, H, Sq, D]
    return ctx.transpose(1, 2).reshape(b, sq, d)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, num_heads: int, head_size: int,
                    rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) @ v per head, in the projection
    layout: q [B, Sq, H*D], k and v [B, Sk, H*D], bias [B, Sk] fp32 (0 for
    live keys, -10000 for padding). Returns [B, Sq, H*D] in q's dtype."""
    if rate != 0.0:
        raise NotImplementedError(
            "fused_attention: dropout (rate > 0) is not ported yet; it "
            "arrives with the backward kernels in the training slice")
    _check_shapes(q, k, v, bias, num_heads, head_size)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, num_heads, head_size)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _launch(q, k, v, bias, num_heads, head_size)


fused_attention.launches = 0


def _check_shapes(q, k, v, bias, num_heads, head_size):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 2:
        raise ValueError("fused_attention: q/k/v must be [B, S, H*D] and "
                         "bias [B, Sk]")
    b, sq, d = q.shape
    sk = k.shape[1]
    if d != num_heads * head_size:
        raise ValueError(f"fused_attention: width {d} != {num_heads} heads "
                         f"x {head_size}")
    if (k.shape != (b, sk, d) or v.shape != (b, sk, d)
            or bias.shape != (b, sk)):
        raise ValueError(
            f"fused_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)} do not agree")
    if (num_heads * sq > MAX_HEADS_TIMES_SEQ
            or num_heads * sk > MAX_HEADS_TIMES_SEQ):
        raise ValueError(
            f"fused_attention: H*Sq = {num_heads * sq}, H*Sk = "
            f"{num_heads * sk}; the short-sequence scope is <= "
            f"{MAX_HEADS_TIMES_SEQ}")
    if len({t.device for t in (q, k, v, bias)}) != 1:
        raise ValueError("fused_attention: q, k, v and bias must share a "
                         "device")


def _library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("fused_attention_fwd")
    if lib.fused_attention_fwd.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.fused_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                            i64, i64, i64, i64, i64, i64, i,
                                            p]
        lib.fused_attention_fwd.restype = ctypes.c_int
        lib.fused_attention_fwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, bias, num_heads, head_size):
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention kernel: q/k/v must share fp32 or "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        raise TypeError("fused_attention kernel: bias must be a contiguous "
                        "fp32 [B, Sk] tensor")
    if head_size != KERNEL_HEAD_SIZE:
        raise ValueError(f"fused_attention kernel: head_size {head_size} "
                         f"(the kernel takes {KERNEL_HEAD_SIZE})")
    if any(t.stride(2) != 1 for t in (q, k, v)):
        raise ValueError("fused_attention kernel: the H*D dimension of "
                         "q/k/v must be contiguous")
    b, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, sq, sk, num_heads, head_size,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.fused_attention_fwd_error_string(rc).decode()
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    fused_attention.launches += 1
    return out
