"""Hidden dropout, residual add and LayerNorm of the transformer output
blocks — Hopper kernels.

`LayerNorm(dropout(y) + residual)`, with y the block's dense output, closes
every attention and FFN output block (`models/layers.py` `AttentionOutput`,
`FFNOutput`). The kernels are `csrc/residual_layernorm.cu`, one forward
and one backward pass over the rows; see its header for the bytes they
move and their design. This module holds their ctypes bindings, their
plain PyTorch versions and the wrapper that chooses between them:

- CPU and `meta` tensors, and every call with `kernels=False`, take
  `plain`: the eager chain the output blocks ran before the kernels.
  `kernels=False` is the model's setting under a second-order optimizer,
  whose double backward the kernels do not have (as for the attention
  kernels, `layers.dispatch_attention`);
- CUDA tensors launch the kernels or raise. There is no fallback.

The keep mask is the eager chain's: one `torch.rand(y.shape, generator=
generator, device=y.device)` a call, only when dropout is live, and
`r < keep_prob`; the forward kernel makes the comparison itself. So the
generators advance as before, and a checkpointed recompute that restores
them draws the same mask.

`residual_layernorm.launches` counts the forward kernel's launches,
`residual_layernorm_bwd.launches` the backward's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import PLAIN_DEVICES, _build

KERNEL_WIDTHS = (768,)  # the `switch` of csrc/residual_layernorm.cu
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
ROWS_PER_BLOCK = 8  # warps of a block, one row each
MAX_BLOCKS = 1056  # eight blocks an SM of the H100


def residual_layernorm(y: torch.Tensor, residual: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor, eps: float,
                       rate: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       kernels: bool = True) -> torch.Tensor:
    """LayerNorm(dropout(y) + residual) over the last dimension, in y's
    dtype: inverted dropout at `rate` (0: none) with its keep mask drawn
    from `generator`, the add rounded to y's dtype, the statistics in fp32
    with fp32 `weight` and `bias`. Differentiable in y, residual, weight
    and bias."""
    _check_rate(rate)
    r = None
    if rate != 0.0:
        if generator is None:
            raise ValueError("residual_layernorm: dropout draws from an "
                             "explicit generator; none was given")
        r = torch.rand(y.shape, generator=generator, device=y.device)
    if not kernels or y.device.type in PLAIN_DEVICES:
        return plain(y, residual, r, weight, bias, eps, rate)
    _check_cuda(y, residual, weight, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, residual, weight, bias)):
        return ResidualLayerNormFunction.apply(y, residual, r, weight, bias,
                                               rate, eps)
    return _launch_fwd(y, residual, r, weight, bias, rate, eps, save=False)[0]


residual_layernorm.launches = 0


# ---------------------------------------------------------- plain versions

def plain(y, residual, r, weight, bias, eps: float, rate: float
          ) -> torch.Tensor:
    """The eager chain: where(r < keep_prob, y / keep_prob, 0) (r None: y),
    plus the residual, LayerNorm in fp32 (fp64 for fp64 tensors), back to
    the sum's dtype."""
    x = y
    if r is not None:
        keep_prob = 1.0 - rate
        x = torch.where(r < keep_prob, y / keep_prob,
                        torch.zeros((), dtype=y.dtype, device=y.device))
    x = x + residual
    return F.layer_norm(x.to(_acc_dtype(x)), (x.shape[-1],), weight, bias,
                        eps).to(x.dtype)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The transcriptions' arithmetic: fp32, or fp64 for fp64 tensors."""
    return torch.promote_types(t.dtype, torch.float32)


def inv_keep_prob(rate: float, dtype: torch.dtype = torch.float32) -> float:
    """1 / keep_prob as eager CUDA scales a tensor by the CPU scalar
    keep_prob: the reciprocal of keep_prob in the arithmetic's dtype."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.tensor(1.0 - rate, dtype=dtype))


def fwd_reference(y, residual, r, weight, bias, rate: float, eps: float):
    """The forward kernel step by step, with its rounding points: (out, z,
    keep, mean, rstd), z and out in y's dtype, keep bool (None without r),
    mean and rstd [rows] in the arithmetic's dtype (`_acc_dtype`)."""
    dt, acc = y.dtype, _acc_dtype(y)
    width = y.shape[-1]
    a = y.reshape(-1, width).to(acc)
    keep = None
    if r is not None:
        keep = r.reshape(-1, width) < torch.tensor(1.0 - rate, dtype=r.dtype)
        a = torch.where(keep, (a * inv_keep_prob(rate, acc)).to(dt).to(acc),
                        0.0)
    z = (a + residual.reshape(-1, width).to(acc)).to(dt)
    zf = z.to(acc)
    mean = zf.mean(-1)
    rstd = torch.rsqrt(((zf - mean[:, None]) ** 2).mean(-1) + eps)
    out = ((zf - mean[:, None]) * rstd[:, None] * weight.to(acc)
           + bias.to(acc)).to(dt)
    shape = y.shape
    return (out.reshape(shape), z.reshape(shape),
            None if keep is None else keep.reshape(shape), mean, rstd)


def bwd_reference(g, z, keep, mean, rstd, weight, rate: float,
                  params: bool = True):
    """The backward kernel step by step: (dz, dy, dweight, dbias), dz and
    dy in z's dtype (dy = dz without keep), dweight and dbias (None unless
    `params`) summed per block of the kernel's rows (`grid_blocks`), then
    over the blocks."""
    dt, acc = z.dtype, _acc_dtype(z)
    width = z.shape[-1]
    gf = g.reshape(-1, width).to(acc)
    xh = (z.reshape(-1, width).to(acc) - mean.to(acc)[:, None]) * rstd.to(
        acc)[:, None]
    gg = gf * weight.to(acc)
    s1 = gg.sum(-1, keepdim=True)
    s2 = (gg * xh).sum(-1, keepdim=True)
    dz = ((width * gg - s1 - xh * s2) * (rstd.to(acc)[:, None] / width)
          ).to(dt)
    dy = dz
    if keep is not None:
        dy = torch.where(keep.reshape(-1, width),
                         (dz.to(acc) * inv_keep_prob(rate, acc)).to(dt), 0.0)
    dw = db = None
    if params:
        rows = gf.shape[0]
        blocks = grid_blocks(rows)
        block = (torch.arange(rows, device=z.device)
                 % (blocks * ROWS_PER_BLOCK)) // ROWS_PER_BLOCK
        part = torch.zeros(2, blocks, width, dtype=acc, device=z.device)
        part[0].index_add_(0, block, gf * xh)
        part[1].index_add_(0, block, gf)
        dw, db = part.sum(1)
    return dz.reshape(z.shape), dy.reshape(z.shape), dw, db


def grid_blocks(rows: int) -> int:
    """Blocks of the kernels' grid: a warp a row, at most MAX_BLOCKS, each
    warp then taking every (blocks * 8)-th row."""
    return max(1, min(-(-rows // ROWS_PER_BLOCK), MAX_BLOCKS))


# ---------------------------------------------------------------- autograd

class ResidualLayerNormFunction(torch.autograd.Function):
    """The forward kernel, saving z (y's dtype), the keep mask (a byte an
    element) and the rows' fp32 mean and rstd, and the backward kernel.
    On CPU tensors (tests only) the transcriptions run in their place."""

    @staticmethod
    def forward(ctx, y, residual, r, weight, bias, rate, eps):
        out, z, keep, mean, rstd = _fwd(y, residual, r, weight, bias, rate,
                                        eps)
        ctx.save_for_backward(z, keep, mean, rstd, weight)
        ctx.rate = rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, keep, mean, rstd, weight = ctx.saved_tensors
        need_y, need_res, _, need_w, need_b = ctx.needs_input_grad[:5]
        dz, dy, dw, db = residual_layernorm_bwd(
            g.contiguous(), z, keep, mean, rstd, weight, ctx.rate,
            dy=need_y, dz=need_res, params=need_w or need_b)
        return (dy, dz, None, dw if need_w else None,
                db if need_b else None, None, None)


def _fwd(y, residual, r, weight, bias, rate, eps):
    if y.device.type in PLAIN_DEVICES:
        return fwd_reference(y, residual, r, weight, bias, rate, eps)
    return _launch_fwd(y, residual, r, weight, bias, rate, eps, save=True)


def residual_layernorm_bwd(g, z, keep, mean, rstd, weight, rate: float,
                           dy: bool = True, dz: bool = True,
                           params: bool = False):
    """(dz, dy, dweight, dbias) from what the forward saved; each is None
    where not asked for, and without a keep mask dy is dz itself."""
    if z.device.type in PLAIN_DEVICES:
        gz, gy, gw, gb = bwd_reference(g, z, keep, mean, rstd, weight, rate,
                                       params)
        return gz if dz else None, gy if dy else None, gw, gb
    return _launch_bwd(g, z, keep, mean, rstd, weight, rate, dy, dz, params)


residual_layernorm_bwd.launches = 0


# ------------------------------------------------------------------ checks

def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"residual_layernorm: dropout rate {rate} not in "
                         f"[0, 1)")


def _check_cuda(y, residual, weight, bias):
    """What the kernels take; raises on anything else."""
    width = y.shape[-1]
    if y.device.type != "cuda":
        raise ValueError(f"residual_layernorm: unsupported device "
                         f"{y.device}")
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"residual_layernorm kernel: width {width}; the "
                         f"kernels are built for {KERNEL_WIDTHS}")
    if y.dtype not in _KERNEL_DTYPES or residual.dtype != y.dtype:
        raise TypeError(f"residual_layernorm kernel: y and the residual "
                        f"must share fp32 or bf16, got {y.dtype}, "
                        f"{residual.dtype}")
    if residual.shape != y.shape or residual.device != y.device:
        raise ValueError(f"residual_layernorm kernel: residual "
                         f"{tuple(residual.shape)} on {residual.device} "
                         f"against y {tuple(y.shape)} on {y.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (width,)
                or t.device != y.device):
            raise TypeError(f"residual_layernorm kernel: {name} must be an "
                            f"fp32 [{width}] tensor on {y.device}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, checked for the kernels' 16-byte loads."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError("residual_layernorm kernel: operands must start "
                         "16-byte aligned")
    return t


# ---------------------------------------------------------------- launches

_p, _i, _i64, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)


def _library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("residual_layernorm")
    if lib.residual_layernorm_fwd.argtypes is None:
        lib.residual_layernorm_fwd.argtypes = [
            _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _i, _i, _f32,
            _f32, _f32, _i, _p]
        lib.residual_layernorm_fwd.restype = ctypes.c_int
        lib.residual_layernorm_bwd.argtypes = [
            _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _i, _i, _f32,
            _i, _p]
        lib.residual_layernorm_bwd.restype = ctypes.c_int
        lib.residual_layernorm_error_string.argtypes = [ctypes.c_int]
        lib.residual_layernorm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = lib.residual_layernorm_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(y, residual, r, weight, bias, rate, eps, save: bool):
    """(out, z, keep, mean, rstd); all but out None unless `save`, keep
    None without r."""
    y, residual = _operand(y), _operand(residual)
    weight, bias = _operand(weight), _operand(bias)
    width = y.shape[-1]
    rows = y.numel() // width
    out = torch.empty_like(y)
    z = torch.empty_like(y) if save else None
    keep = (torch.empty(y.shape, dtype=torch.bool, device=y.device)
            if save and r is not None else None)
    mean, rstd = ((torch.empty(rows, dtype=torch.float32, device=y.device),
                   torch.empty(rows, dtype=torch.float32, device=y.device))
                  if save else (None, None))
    keep_prob = float(torch.tensor(1.0 - rate, dtype=torch.float32))
    lib = _library()
    with torch.cuda.device(y.device):
        rc = lib.residual_layernorm_fwd(
            y.data_ptr(), residual.data_ptr(), _ptr(r), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), _ptr(z), _ptr(keep), _ptr(mean),
            _ptr(rstd), rows, width, int(y.dtype == torch.bfloat16),
            keep_prob, inv_keep_prob(rate), eps, grid_blocks(rows),
            torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(rc, lib, "residual_layernorm_fwd")
    residual_layernorm.launches += 1
    return out, z, keep, mean, rstd


def _launch_bwd(g, z, keep, mean, rstd, weight, rate, dy: bool, dz: bool,
                params: bool):
    width = z.shape[-1]
    rows = z.numel() // width
    if g.shape != z.shape or g.dtype != z.dtype:
        raise TypeError(f"residual_layernorm backward kernel: g "
                        f"{g.dtype} {tuple(g.shape)} against the saved "
                        f"{z.dtype} {tuple(z.shape)}")
    g, weight = _operand(g), _operand(weight)
    # without a mask dy is dz, written once
    want_dz = dz or (dy and keep is None)
    gz = torch.empty_like(z) if want_dz else None
    gy = torch.empty_like(z) if dy and keep is not None else None
    blocks = grid_blocks(rows)
    part = gw = gb = None
    if params:
        part = torch.empty(2, blocks, width, dtype=torch.float32,
                           device=z.device)
        gw = torch.empty(width, dtype=torch.float32, device=z.device)
        gb = torch.empty(width, dtype=torch.float32, device=z.device)
    lib = _library()
    with torch.cuda.device(z.device):
        rc = lib.residual_layernorm_bwd(
            g.data_ptr(), z.data_ptr(), _ptr(keep), mean.data_ptr(),
            rstd.data_ptr(), weight.data_ptr(), _ptr(gz), _ptr(gy),
            _ptr(part), _ptr(gw), _ptr(gb), rows, width,
            int(z.dtype == torch.bfloat16), inv_keep_prob(rate), blocks,
            torch.cuda.current_stream(z.device).cuda_stream)
    _raise_on(rc, lib, "residual_layernorm_bwd")
    residual_layernorm_bwd.launches += 1
    if dy and keep is None:
        gy = gz
    return gz if dz else None, gy, gw, gb
