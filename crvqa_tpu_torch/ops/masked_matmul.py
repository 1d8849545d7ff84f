"""Fused masked matmul y = x @ (w ⊙ [scores > threshold]) — Hopper kernels.

Counterpart of `crvqa_tpu/ops/masked_matmul.py`. The kernels are
`csrc/masked_matmul.cu` (an operand pass and the split reduction of ds) and
the TMA + `wgmma` product of `csrc/wgmma_gemm_common.cuh`; see their
headers for what each replaces, its bound and its design. Like the JAX
package's, this op is reached by no entry point: the stage-2 and stage-3
paths mask weights with `w * binarize(s, t)` before cuBLAS (the JAX
module's measured verdict).

Semantics, kept exactly: every operand is rounded to bf16 before the
product, even fp32 ones; sums are fp32; y and dx come out in x's dtype, ds
in w's dtype and then the scores' (fp32); the threshold is compared against
the fp32 scores in fp32, never in w's dtype. Gradients (straight-through):

    dx = g @ (w ⊙ m)ᵀ;   dscores = (xᵀ g) ⊙ w;   dw = 0;   dthreshold = 0

On the card each call first rounds what the product's TMA cannot read in
place (`_tma_ready`: anything but bf16 rows on the 16-byte grid) into a
bf16 buffer, and packs bf16(w ⊙ m) once (`operand_pass`); ds splits its
sum over M by `ds_plan`. Each wrapper chooses by the tensor's device: a CPU
or `meta` tensor takes the plain version (the same bf16-rounded operands,
products in fp32), a CUDA tensor launches the kernels or raises. Each
counts its calls on the card in `.launches`: `masked_matmul_fwd`,
`masked_matmul_dx`, `masked_matmul_ds`, `operand_pass`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import PLAIN_DEVICES, _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# the product kernel's tile (rows, columns, reduction step) and the blocks
# one SM holds (csrc/wgmma_gemm_common.cuh); the fewest reduction steps a
# split of ds is given, and the most splits (each adds a K x N fp32
# partial to write and read back)
TILE = (128, 128, 64)
BLOCKS_PER_SM = 2
MIN_SPLIT_STEPS = 8
MAX_SPLITS = 8
_FWD, _DX, _DS = 0, 1, 2             # masked_matmul_product's kinds
_STORE, _STE, _PARTIAL = 0, 1, 2    # its epilogue modes


# ---------------------------------------------------------- plain versions

def _threshold(threshold, scores: torch.Tensor) -> torch.Tensor:
    """The threshold as one fp32 value on the scores' device (`t.astype(
    scores.dtype)` of the JAX calls)."""
    return torch.as_tensor(threshold, device=scores.device).to(
        scores.dtype).reshape(())


def operand_pass_reference(t: torch.Tensor, scores=None, threshold=None
                           ) -> torch.Tensor:
    """Plain version of the operand pass: bf16(t ⊙ [scores > threshold]),
    the mask in t's dtype first, as the TPU kernel's `(w * mask).astype(
    bf16)` (:57-58); bf16(t) without scores."""
    if scores is not None:
        t = t * (scores > _threshold(threshold, scores)).to(t.dtype)
    return t.to(torch.bfloat16)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def masked_matmul_fwd_reference(x, w, scores, threshold) -> torch.Tensor:
    """Plain version of the forward: bf16(x) @ bf16(w ⊙ m), fp32 sums, in
    x's dtype."""
    wm = operand_pass_reference(w, scores, threshold).float()
    return (_bf16(x) @ wm).to(x.dtype)


def masked_matmul_dx_reference(g, w, scores, threshold, x_dtype
                               ) -> torch.Tensor:
    """Plain version of dx: bf16(g) @ bf16(w ⊙ m)ᵀ in x's dtype."""
    wm = operand_pass_reference(w, scores, threshold).float()
    return (_bf16(g) @ wm.T).to(x_dtype)


def masked_matmul_ds_reference(x, g, w) -> torch.Tensor:
    """Plain version of ds: (bf16(x)ᵀ bf16(g)) ⊙ w, rounded to w's dtype
    (the TPU kernel's output dtype, :189), returned in fp32."""
    return ((_bf16(x).T @ _bf16(g)) * w.float()).to(w.dtype).float()


def masked_matmul_reference(x, w, scores, threshold) -> torch.Tensor:
    """The JAX module's XLA reference (`masked_matmul_reference` :218):
    x @ (w ⊙ m) in the promoted dtype, no bf16 rounding."""
    mask = (scores > _threshold(threshold, scores)).to(w.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ (w * mask).to(dt)


# ------------------------------------------------------------------ routes

def _tma_ready(t: torch.Tensor) -> bool:
    """Whether the product's TMA reads `t` in place: a 2-D bf16 matrix with
    unit inner stride, rows that do not overlap, and a row pitch and a start
    on the 16-byte grid. Anything else goes through the operand pass."""
    if t.dtype != torch.bfloat16 or t.dim() != 2:
        return False
    rows, cols = t.shape
    if cols > 1 and t.stride(1) != 1:
        return False
    if rows > 1 and (t.stride(0) % 8 or t.stride(0) < cols):
        return False
    return t.data_ptr() % 16 == 0


def _pitch(t: torch.Tensor) -> int:
    """Row pitch in elements of a `_tma_ready` matrix (a single row: its
    width on the 16-byte grid)."""
    return t.stride(0) if t.shape[0] > 1 else -(-t.shape[1] // 8) * 8


@dataclasses.dataclass(frozen=True)
class DsPlan:
    """How ds runs: `tiles` output tiles of TILE[0] x TILE[1], each summing
    its M rows in `splits` ranges of `chunk` steps of TILE[2] rows."""
    tiles: int
    splits: int
    chunk: int

    def row_ranges(self, m: int) -> list[tuple[int, int]]:
        """Each split's rows [start, stop) of x and g, in order."""
        step = self.chunk * TILE[2]
        return [(z * step, min((z + 1) * step, m))
                for z in range(self.splits)]


def ds_plan(m: int, k: int, n: int, sms: int) -> DsPlan:
    """ds's launch plan for x [m, k], g [m, n] on a card of `sms` SMs: as
    many splits of the M rows as fit one wave of resident blocks beside
    the K x N tiles, each split at least MIN_SPLIT_STEPS steps long; a
    single split (the STE in the product's epilogue) when the tiles alone
    fill the wave."""
    tiles = -(-k // TILE[0]) * -(-n // TILE[1])
    steps = -(-m // TILE[2])
    splits = max(1, min(sms * BLOCKS_PER_SM // tiles,
                        steps // MIN_SPLIT_STEPS, MAX_SPLITS))
    chunk = -(-steps // splits)
    return DsPlan(tiles, -(-steps // chunk), chunk)


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


def operand_pass(t: torch.Tensor, scores=None, threshold=None
                 ) -> torch.Tensor:
    """The operand pass: bf16(t ⊙ [scores > threshold]) (mask mode; the
    threshold a device fp32 value, as `_check_cuda` returns it) or bf16(t)
    (copy mode), as a [R, C] view of a [R, ceil(C / 8) * 8] buffer, so its
    rows start on the 16-byte grid (plain version on CPU tensors)."""
    if t.device.type in PLAIN_DEVICES:
        return operand_pass_reference(t, scores, threshold)
    threshold = _check_cuda((t,), scores, threshold)
    rows, cols = t.shape
    ldd = -(-cols // 8) * 8
    out = torch.empty((rows, ldd), dtype=torch.bfloat16, device=t.device)
    if scores is not None:
        t, scores = t.contiguous(), scores.contiguous()
    lib = _library()
    with torch.cuda.device(t.device):
        rc = lib.masked_matmul_operand_pass(
            t.data_ptr(), t.stride(0), t.stride(1), _is_bf16(t),
            None if scores is None else scores.data_ptr(),
            None if scores is None else threshold.data_ptr(),
            out.data_ptr(), ldd, rows, cols, _stream(t))
    _raise_on(rc, lib)
    operand_pass.launches += 1
    return out[:, :cols]


operand_pass.launches = 0


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    return t if _tma_ready(t) else operand_pass(t)


def _product(kind, a, b, out, m, n, k, mode, *, e=None, splits=1,
             chunk=None):
    lib = _library()
    with torch.cuda.device(out.device):
        rc = lib.masked_matmul_product(
            kind, a.data_ptr(), _pitch(a), b.data_ptr(), _pitch(b), m, n, k,
            out.data_ptr(), out.shape[-1], mode, _is_bf16(out),
            None if e is None else e.data_ptr(),
            0 if e is None else e.stride(0), 0 if e is None else _is_bf16(e),
            splits, chunk or -(-k // TILE[2]), _stream(out))
    _raise_on(rc, lib)


def masked_matmul_fwd(x, w, scores, threshold) -> torch.Tensor:
    """The forward: the packed bf16(w ⊙ m), then x @ it on the product
    kernel (plain version on CPU tensors)."""
    _check_shapes(x, w, scores)
    if x.device.type in PLAIN_DEVICES:
        return masked_matmul_fwd_reference(x, w, scores, threshold)
    t = _check_cuda((x, w), scores, threshold)
    m, k = x.shape
    n = w.shape[1]
    wm = operand_pass(w, scores, t)
    xa = _tma_operand(x)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _product(_FWD, xa, wm, y, m, n, k, _STORE)
    masked_matmul_fwd.launches += 1
    return y


masked_matmul_fwd.launches = 0


def masked_matmul_dx(g, w, scores, threshold, x_dtype: torch.dtype
                     ) -> torch.Tensor:
    """dx: g [M, N] -> g @ (w ⊙ m)ᵀ [M, K] in `x_dtype` (g's dtype on the
    card, which is y's and so x's); the packed w ⊙ m read K-major."""
    if g.device.type in PLAIN_DEVICES:
        return masked_matmul_dx_reference(g, w, scores, threshold, x_dtype)
    if g.dtype != x_dtype:
        raise TypeError(f"masked_matmul dx kernel: g is {g.dtype}, x "
                        f"{x_dtype}; the cotangent has y's dtype, x's")
    if g.dim() != 2 or w.dim() != 2 or g.shape[1] != w.shape[1] or (
            scores.shape != w.shape):
        raise ValueError(f"masked_matmul dx: g [M, N], w and scores [K, N]; "
                         f"got {tuple(g.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scores.shape)}")
    t = _check_cuda((g, w), scores, threshold)
    m, n = g.shape
    k = w.shape[0]
    wm = operand_pass(w, scores, t)
    ga = _tma_operand(g)
    dx = torch.empty((m, k), dtype=x_dtype, device=g.device)
    _product(_DX, ga, wm, dx, m, k, n, _STORE)
    masked_matmul_dx.launches += 1
    return dx


masked_matmul_dx.launches = 0


def masked_matmul_ds(x, g, w) -> torch.Tensor:
    """ds: (xᵀ g) ⊙ w [K, N] in fp32 (the scores' dtype), each value
    rounded to w's dtype first; x read MN-major, the M rows summed in
    `ds_plan`'s splits and added in split order."""
    if x.device.type in PLAIN_DEVICES:
        return masked_matmul_ds_reference(x, g, w)
    _check_cuda((x, g, w), None, None)
    if x.dim() != 2 or g.dim() != 2 or g.shape[0] != x.shape[0] or (
            w.shape != (x.shape[1], g.shape[1])):
        raise ValueError(f"masked_matmul ds: x [M, K], g [M, N], w [K, N]; "
                         f"got {tuple(x.shape)}, {tuple(g.shape)}, "
                         f"{tuple(w.shape)}")
    w = w.contiguous()
    m, k = x.shape
    n = g.shape[1]
    xa, ga = _tma_operand(x), _tma_operand(g)
    plan = ds_plan(m, k, n, _sm_count(x.device))
    ds = torch.empty((k, n), dtype=torch.float32, device=x.device)
    if plan.splits == 1:
        _product(_DS, xa, ga, ds, k, n, m, _STE, e=w)
    else:
        part = torch.empty((plan.splits, k, n), dtype=torch.float32,
                           device=x.device)
        _product(_DS, xa, ga, part, k, n, m, _PARTIAL, splits=plan.splits,
                 chunk=plan.chunk)
        lib = _library()
        with torch.cuda.device(x.device):
            rc = lib.masked_matmul_ds_reduce(
                part.data_ptr(), plan.splits, k * n, w.data_ptr(),
                _is_bf16(w), ds.data_ptr(), _stream(x))
        _raise_on(rc, lib)
    masked_matmul_ds.launches += 1
    return ds


masked_matmul_ds.launches = 0


class MaskedMatmulFunction(torch.autograd.Function):
    """`masked_matmul`'s custom VJP (`_mm_fwd` / `_mm_bwd` :202-212): the
    forward kernel; dx and the STE ds from their kernels, zeros for w and
    the threshold. ds takes a bf16 cotangent as it is: every operand is
    rounded to bf16, and bf16 -> fp32 -> bf16 is exact, so this gives the
    bits of the JAX VJP's `g.astype(f32)` (:210), which other dtypes keep."""

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
            gs = g if g.dtype == torch.bfloat16 else g.float()
            ds = masked_matmul_ds(x, gs, w).to(scores.dtype)
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
    if lib.masked_matmul_product.argtypes is None:
        lib.masked_matmul_operand_pass.argtypes = [
            _p, _i64, _i64, _i, _p, _p, _p, _i64, _i, _i, _p]
        lib.masked_matmul_product.argtypes = [
            _i, _p, _i64, _p, _i64, _i, _i, _i, _p, _i64, _i, _i, _p, _i64,
            _i, _i, _i, _p]
        lib.masked_matmul_ds_reduce.argtypes = [_p, _i, _i64, _p, _i, _p, _p]
        lib.masked_matmul_blocks_per_sm.argtypes = [_i]
        for fn in (lib.masked_matmul_operand_pass, lib.masked_matmul_product,
                   lib.masked_matmul_ds_reduce,
                   lib.masked_matmul_blocks_per_sm):
            fn.restype = ctypes.c_int
        lib.masked_matmul_error_string.argtypes = [ctypes.c_int]
        lib.masked_matmul_error_string.restype = ctypes.c_char_p
    return lib


def blocks_per_sm() -> dict[str, int]:
    """Blocks of each product kernel (forward, dx, ds) one SM holds, from
    the CUDA occupancy calculator on the current card."""
    lib = _library()
    return {name: lib.masked_matmul_blocks_per_sm(kind)
            for name, kind in (("fwd", _FWD), ("dx", _DX), ("ds", _DS))}


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, lib) -> None:
    if rc != 0:
        msg = lib.masked_matmul_error_string(rc).decode()
        raise RuntimeError(f"masked_matmul kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
