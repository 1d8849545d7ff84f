"""Fused masked matmul y = x @ (w ⊙ [scores > threshold]) — Hopper kernels.

Counterpart of `crvqa_tpu/ops/masked_matmul.py`. The three kernels
(forward, dx, STE dscores) are `csrc/masked_matmul.cu`; see its header for
what each replaces, its bound and its design. Like the JAX package's, this
op is reached by no entry point: the stage-2 and stage-3 paths mask weights
with `w * binarize(s, t)` before cuBLAS (the JAX module's measured verdict).

Semantics, kept exactly: every operand is rounded to bf16 before the
product, even fp32 ones; sums are fp32; y and dx come out in x's dtype, ds
in w's dtype and then the scores' (fp32); the threshold is compared against
the fp32 scores in fp32, never in w's dtype. Gradients (straight-through):

    dx = g @ (w ⊙ m)ᵀ;   dscores = (xᵀ g) ⊙ w;   dw = 0;   dthreshold = 0

Each wrapper chooses by the tensor's device: a CPU tensor takes the plain
version (the same bf16-rounded operands, products in fp32), a CUDA tensor
launches the kernel or raises. Each counts its launches in `.launches`:
`masked_matmul_fwd`, `masked_matmul_dx`, `masked_matmul_ds`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------- plain versions

def _threshold(threshold, scores: torch.Tensor) -> torch.Tensor:
    """The threshold as one fp32 value on the scores' device (`t.astype(
    scores.dtype)` of the JAX calls)."""
    return torch.as_tensor(threshold, device=scores.device).to(
        scores.dtype).reshape(())


def _masked_bf16(w, scores, threshold) -> torch.Tensor:
    """fp32 view of bf16(w ⊙ [s > t]), the mask in w's dtype first (:57-58)."""
    mask = (scores > _threshold(threshold, scores)).to(w.dtype)
    return (w * mask).to(torch.bfloat16).float()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def masked_matmul_fwd_reference(x, w, scores, threshold) -> torch.Tensor:
    """Plain version of the forward kernel: bf16(x) @ bf16(w ⊙ m), fp32
    sums, in x's dtype."""
    return (_bf16(x) @ _masked_bf16(w, scores, threshold)).to(x.dtype)


def masked_matmul_dx_reference(g, w, scores, threshold, x_dtype
                               ) -> torch.Tensor:
    """Plain version of the dx kernel: bf16(g) @ bf16(w ⊙ m)ᵀ in x's dtype."""
    return (_bf16(g) @ _masked_bf16(w, scores, threshold).T).to(x_dtype)


def masked_matmul_ds_reference(x, g, w) -> torch.Tensor:
    """Plain version of the ds kernel: (bf16(x)ᵀ bf16(g)) ⊙ w, rounded to
    w's dtype (the TPU kernel's output dtype, :189), returned in fp32."""
    return ((_bf16(x).T @ _bf16(g)) * w.float()).to(w.dtype).float()


def masked_matmul_reference(x, w, scores, threshold) -> torch.Tensor:
    """The JAX module's XLA reference (`masked_matmul_reference` :218):
    x @ (w ⊙ m) in the promoted dtype, no bf16 rounding."""
    mask = (scores > _threshold(threshold, scores)).to(w.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ (w * mask).to(dt)


# ---------------------------------------------------------------- wrappers

def masked_matmul(x: torch.Tensor, w: torch.Tensor, scores: torch.Tensor,
                  threshold) -> torch.Tensor:
    """y = x @ (w ⊙ [scores > threshold]); x [M, K], w and scores [K, N],
    threshold a scalar (a 0-d tensor or a number). Gradients flow to x and
    (straight-through) to the scores; w and the threshold get zeros."""
    _check_shapes(x, w, scores)
    if not isinstance(threshold, torch.Tensor):
        threshold = _threshold(threshold, scores)
    return MaskedMatmulFunction.apply(x, w, scores, threshold)


def masked_matmul_fwd(x, w, scores, threshold) -> torch.Tensor:
    """The forward kernel (plain version on CPU tensors)."""
    _check_shapes(x, w, scores)
    if x.device.type == "cpu":
        return masked_matmul_fwd_reference(x, w, scores, threshold)
    t = _check_cuda((x, w), scores, threshold)
    w, scores = w.contiguous(), scores.contiguous()
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.masked_matmul_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
            scores.data_ptr(), w.stride(0), w.stride(1), t.data_ptr(),
            y.data_ptr(), m, k, n, _is_bf16(x), _is_bf16(w), _stream(x))
    _raise_on(rc, lib)
    masked_matmul_fwd.launches += 1
    return y


masked_matmul_fwd.launches = 0


def masked_matmul_dx(g, w, scores, threshold, x_dtype: torch.dtype
                     ) -> torch.Tensor:
    """The dx kernel: g [M, N] -> dx [M, K] in `x_dtype` (g's dtype on the
    card, which is y's and so x's)."""
    if g.device.type == "cpu":
        return masked_matmul_dx_reference(g, w, scores, threshold, x_dtype)
    if g.dtype != x_dtype:
        raise TypeError(f"masked_matmul dx kernel: g is {g.dtype}, x "
                        f"{x_dtype}; the cotangent has y's dtype, x's")
    t = _check_cuda((g, w), scores, threshold)
    w, scores = w.contiguous(), scores.contiguous()
    m, n = g.shape
    k = w.shape[0]
    dx = torch.empty((m, k), dtype=x_dtype, device=g.device)
    lib = _library()
    with torch.cuda.device(g.device):
        rc = lib.masked_matmul_dx(
            g.data_ptr(), g.stride(0), g.stride(1), w.data_ptr(),
            scores.data_ptr(), w.stride(0), w.stride(1), t.data_ptr(),
            dx.data_ptr(), m, k, n, _is_bf16(g), _is_bf16(w), _stream(g))
    _raise_on(rc, lib)
    masked_matmul_dx.launches += 1
    return dx


masked_matmul_dx.launches = 0


def masked_matmul_ds(x, g, w) -> torch.Tensor:
    """The ds kernel: (xᵀ g) ⊙ w [K, N] in fp32 (the scores' dtype), each
    value rounded to w's dtype first."""
    if x.device.type == "cpu":
        return masked_matmul_ds_reference(x, g, w)
    _check_cuda((x, g, w), None, None)
    w = w.contiguous()
    m, k = x.shape
    n = g.shape[1]
    ds = torch.empty((k, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.masked_matmul_ds(
            x.data_ptr(), x.stride(0), x.stride(1), g.data_ptr(),
            g.stride(0), g.stride(1), w.data_ptr(), w.stride(0), w.stride(1),
            ds.data_ptr(), m, k, n, _is_bf16(x), _is_bf16(g), _is_bf16(w),
            _stream(x))
    _raise_on(rc, lib)
    masked_matmul_ds.launches += 1
    return ds


masked_matmul_ds.launches = 0


class MaskedMatmulFunction(torch.autograd.Function):
    """`masked_matmul`'s custom VJP (`_mm_fwd` / `_mm_bwd` :202-212): the
    forward kernel; dx and the STE ds (g cast to fp32 first, as :210) from
    their kernels, zeros for w and the threshold."""

    @staticmethod
    def forward(ctx, x, w, scores, threshold):
        ctx.save_for_backward(x, w, scores, threshold)
        return masked_matmul_fwd(x, w, scores, threshold)

    @staticmethod
    def backward(ctx, g):
        x, w, scores, threshold = ctx.saved_tensors
        dx = ds = None
        if ctx.needs_input_grad[0]:
            dx = masked_matmul_dx(g.to(x.dtype), w, scores, threshold,
                                  x.dtype)
        if ctx.needs_input_grad[2]:
            ds = masked_matmul_ds(x, g.float(), w).to(scores.dtype)
        dw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        dt = (torch.zeros_like(threshold) if ctx.needs_input_grad[3]
              else None)
        return dx, dw, ds, dt


# ------------------------------------------------------------------ checks

def _check_shapes(x, w, scores):
    if x.dim() != 2 or w.dim() != 2 or scores.shape != w.shape:
        raise ValueError(f"masked_matmul: x [M, K], w and scores [K, N]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scores.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"masked_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")


def _check_cuda(operands, scores, threshold):
    """What the kernels take; returns the threshold as a device fp32 value
    (None without scores). Raises on anything else."""
    dev = operands[0].device
    if dev.type != "cuda":
        raise ValueError(f"masked_matmul: unsupported device {dev}")
    for t in operands:
        if t.device != dev:
            raise ValueError("masked_matmul: operands on different devices")
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"masked_matmul kernel: fp32 or bf16 operands, "
                            f"got {t.dtype}")
    if scores is None:
        return None
    if scores.device != dev or scores.dtype != torch.float32:
        raise TypeError("masked_matmul kernel: scores must be fp32 on the "
                        "operands' device")
    return _threshold(threshold, scores).contiguous()


# ---------------------------------------------------------------- launches

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("masked_matmul")
    if lib.masked_matmul_fwd.argtypes is None:
        lib.masked_matmul_fwd.argtypes = [
            _p, _i64, _i64, _p, _p, _i64, _i64, _p, _p, _i, _i, _i, _i, _i,
            _p]
        lib.masked_matmul_dx.argtypes = list(lib.masked_matmul_fwd.argtypes)
        lib.masked_matmul_ds.argtypes = [
            _p, _i64, _i64, _p, _i64, _i64, _p, _i64, _i64, _p, _i, _i, _i,
            _i, _i, _i, _p]
        for fn in (lib.masked_matmul_fwd, lib.masked_matmul_dx,
                   lib.masked_matmul_ds):
            fn.restype = ctypes.c_int
        lib.masked_matmul_error_string.argtypes = [ctypes.c_int]
        lib.masked_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, lib) -> None:
    if rc != 0:
        msg = lib.masked_matmul_error_string(rc).decode()
        raise RuntimeError(f"masked_matmul kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
