"""Structured-mask (head-pruned) matmuls: compute only the kept heads.

Counterpart of `crvqa_tpu/ops/structured_matmul.py`. Head masking zeroes
whole `head_size`-wide output column blocks of a Q/K/V weight; with k of H
heads masked the product needs only (H - k) / H of the work. Three
functions, each returning the dense [M, N] output with the masked head
columns exactly zero:

- `head_compact_matmul`: plain torch (the JAX module's XLA path): gather the
  kept head blocks of w, one `torch.matmul`, scatter into zeros; its
  backward is the dense masked one (`HeadCompactFunction`);
- `head_compact_matmul_pallas`: the kernel `csrc/head_compact_matmul.cu`
  (the TPU kernel's counterpart, on the TMA + `wgmma` product of
  `csrc/wgmma_gemm_common.cuh`; w given transposed as wt [N, K]; forward
  only, as in the JAX package). A CPU or `meta` tensor takes its plain
  version, a CUDA tensor launches it or raises. An operand the kernel's
  TMA cannot read in place (`_tma_ready`: anything but bf16 rows on the
  16-byte grid) is first rounded into a bf16 buffer by `operand_pass`,
  which is exact: the kernel rounds both operands to bf16 anyway.
  `head_compact_matmul_pallas.launches` and `operand_pass.launches` count
  the launches;
- `dense_masked_matmul`: the baseline, x @ (w ⊙ expand(head_mask)).

Like the JAX package's, none is reached by an entry point: stage 3 compacts
the checkpoint once on the host instead (`masking/compaction.py`).

Kept-head indices come from `expand_keep_idx`, padded with the sentinel H
that every scatter drops, so the output is x @ (w ⊙ mask) for every mask,
the all-masked one included.
"""
from __future__ import annotations

import ctypes

import torch

from . import PLAIN_DEVICES, _build
from .masked_matmul import _pitch, _tma_ready

KERNEL_HEAD_SIZE = 64
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def expand_keep_idx(head_mask: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Indices (int64) of the kept heads of a bool [H] mask, kept first in
    order, padded to `n_keep` with the out-of-range sentinel H (also for an
    all-masked mask): `expand_keep_idx` :62."""
    num_heads = head_mask.shape[0]
    idx = torch.argsort((~head_mask).to(torch.int8), stable=True)
    n_kept = int(head_mask.sum())
    slots = torch.arange(n_keep, device=head_mask.device)
    pos = torch.clamp(slots, max=max(n_kept - 1, 0))
    return torch.where(slots < n_kept, idx[pos],
                       torch.full_like(pos, num_heads))


def _scatter_heads(y_kept: torch.Tensor, keep_idx: torch.Tensor, m: int,
                   num_heads: int, head_size: int) -> torch.Tensor:
    """[M, n_keep*hs] -> dense [M, H*hs]: each slot's block at its head,
    sentinel slots dropped (the JAX `.at[].set(mode="drop")`): they land
    in one spare head past the end that is cut off, so nothing waits on
    the host for the count of valid slots."""
    y3 = torch.zeros((m, num_heads + 1, head_size), dtype=y_kept.dtype,
                     device=y_kept.device)
    y3[:, keep_idx.clamp(max=num_heads)] = y_kept.reshape(m, -1, head_size)
    return y3[:, :num_heads].reshape(m, num_heads * head_size)


def _head_column_mask(keep_idx, num_heads, head_size, dtype) -> torch.Tensor:
    """[H*hs] 1/0 of the heads in keep_idx (sentinels dropped)."""
    mask_h = torch.zeros(num_heads + 1, dtype=dtype, device=keep_idx.device)
    mask_h[keep_idx.clamp(max=num_heads)] = 1
    return mask_h[:num_heads].repeat_interleave(head_size)


# ------------------------------------------------------- plain torch path

class HeadCompactFunction(torch.autograd.Function):
    """`head_compact_matmul`'s custom VJP (`_compact_fwd` / `_compact_bwd`
    :88-111): a compact forward, the dense masked backward (masked head
    columns of w get exactly zero gradient; the scores' STE is not this
    op's job)."""

    @staticmethod
    def forward(ctx, x, w, keep_idx, num_heads, head_size):
        m, k = x.shape
        fetch = keep_idx.clamp(max=num_heads - 1)
        wk = w.reshape(k, num_heads, head_size).index_select(1, fetch)
        dt = torch.promote_types(x.dtype, w.dtype)
        yk = (x.to(dt) @ wk.reshape(k, -1).to(dt)).to(x.dtype)
        ctx.save_for_backward(x, w, keep_idx)
        ctx.heads = (num_heads, head_size)
        return _scatter_heads(yk, keep_idx, m, num_heads, head_size)

    @staticmethod
    def backward(ctx, g):
        x, w, keep_idx = ctx.saved_tensors
        num_heads, head_size = ctx.heads
        mask = _head_column_mask(keep_idx, num_heads, head_size, w.dtype)
        wm = w * mask[None, :]
        dt = torch.promote_types(g.dtype, w.dtype)
        dx = (g.to(dt) @ wm.to(dt).T).to(g.dtype)
        dw = ((x.to(dt).T @ g.to(dt)).to(g.dtype) * mask[None, :])
        return dx, dw.to(w.dtype), None, None, None


def head_compact_matmul(x: torch.Tensor, w: torch.Tensor,
                        keep_idx: torch.Tensor, num_heads: int,
                        head_size: int) -> torch.Tensor:
    """y = x @ (w ⊙ head_mask) computing only the kept head columns: x
    [M, K], w [K, H*hs], keep_idx from `expand_keep_idx`."""
    return HeadCompactFunction.apply(x, w, keep_idx, num_heads, head_size)


def dense_masked_matmul(x: torch.Tensor, w: torch.Tensor,
                        head_mask: torch.Tensor, head_size: int
                        ) -> torch.Tensor:
    """The baseline (:189): x @ (w ⊙ repeat(head_mask, hs)) in x's dtype."""
    mask = head_mask.to(w.dtype).repeat_interleave(head_size)
    dt = torch.promote_types(x.dtype, w.dtype)
    return (x.to(dt) @ (w * mask[None, :]).to(dt)).to(x.dtype)


# ------------------------------------------------------------ kernel path

def head_compact_matmul_pallas_reference(x, wt, keep_idx, num_heads: int,
                                         head_size: int) -> torch.Tensor:
    """Plain version of the kernel: each kept head's block bf16(x) @
    bf16(wt[head rows])ᵀ with fp32 sums, in x's dtype, scattered into the
    dense output (pads dropped, every other column zero)."""
    m, k = x.shape
    fetch = keep_idx.clamp(max=num_heads - 1)
    blocks = wt.reshape(num_heads, head_size, k).index_select(0, fetch)
    yc = (x.to(torch.bfloat16).float()
          @ blocks.reshape(-1, k).to(torch.bfloat16).float().T)
    return _scatter_heads(yc.to(x.dtype), keep_idx, m, num_heads, head_size)


def operand_pass_reference(t: torch.Tensor) -> torch.Tensor:
    """Plain version of the operand pass: bf16(t), as the TPU kernel's
    `.astype(jnp.bfloat16)` of each operand (:129)."""
    return t.to(torch.bfloat16)


def operand_pass(t: torch.Tensor) -> torch.Tensor:
    """bf16(t) as a [R, C] view of a [R, ceil(C / 8) * 8] buffer, so its rows
    start on the 16-byte grid (plain version on CPU tensors)."""
    if t.device.type in PLAIN_DEVICES:
        return operand_pass_reference(t)
    if t.dtype not in _KERNEL_DTYPES or t.dim() != 2:
        raise TypeError(f"head_compact_matmul operand pass: a 2-D fp32 or "
                        f"bf16 matrix, got {t.dtype} {tuple(t.shape)}")
    rows, cols = t.shape
    ldd = -(-cols // 8) * 8
    out = torch.empty((rows, ldd), dtype=torch.bfloat16, device=t.device)
    lib = _library()
    with torch.cuda.device(t.device):
        rc = lib.head_compact_operand_pass(
            t.data_ptr(), t.stride(0), t.stride(1),
            int(t.dtype == torch.bfloat16), out.data_ptr(), ldd, rows, cols,
            torch.cuda.current_stream(t.device).cuda_stream)
    _raise_on(rc, lib)
    operand_pass.launches += 1
    return out[:, :cols]


operand_pass.launches = 0


def rounded_operands(x: torch.Tensor, wt: torch.Tensor) -> tuple[bool, bool]:
    """Whether the wrapper rounds x and wt through `operand_pass` before the
    product (the kernel's TMA reads the others in place)."""
    return not _tma_ready(x), not _tma_ready(wt)


def head_compact_matmul_pallas(x: torch.Tensor, wt: torch.Tensor,
                               keep_idx: torch.Tensor, num_heads: int,
                               head_size: int, bm: int = 512, bk: int = 256
                               ) -> torch.Tensor:
    """y = x @ (w ⊙ head_mask) with w given transposed, wt [N, K]: only the
    kept heads' rows of wt are read (`head_compact_matmul_pallas` :137;
    forward only). `bm` / `bk` are the JAX function's tiles, kept for its
    preconditions M % bm == 0 and K % bk == 0 (:150-151); the kernel itself
    takes any M and K. keep_idx entries outside [0, H) write nothing."""
    m, k = x.shape
    n = wt.shape[0]
    if n != num_heads * head_size or wt.shape[1] != k:
        raise ValueError(f"head_compact_matmul: wt {tuple(wt.shape)} is not "
                         f"[{num_heads} x {head_size}, {k}]")
    if m % bm or k % bk:
        raise ValueError(f"head_compact_matmul: M={m}, K={k} are not "
                         f"multiples of bm={bm}, bk={bk}")
    if (x.device.type in PLAIN_DEVICES
            and wt.device.type == x.device.type):
        return head_compact_matmul_pallas_reference(x, wt, keep_idx,
                                                    num_heads, head_size)
    if x.device.type != "cuda" or wt.device != x.device:
        raise ValueError(f"head_compact_matmul: unsupported devices "
                         f"{x.device}, {wt.device}")
    if x.dtype not in _KERNEL_DTYPES or wt.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"head_compact_matmul kernel: fp32 or bf16 operands, "
                        f"got {x.dtype}, {wt.dtype}")
    if head_size != KERNEL_HEAD_SIZE:
        raise ValueError(f"head_compact_matmul kernel: head_size {head_size} "
                         f"(the kernel takes {KERNEL_HEAD_SIZE})")
    keep = keep_idx.to(x.device, torch.int32).contiguous()
    round_x, round_wt = rounded_operands(x, wt)
    xa = operand_pass(x) if round_x else x
    wa = operand_pass(wt) if round_wt else wt
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.head_compact_matmul(
            xa.data_ptr(), _pitch(xa), wa.data_ptr(), _pitch(wa),
            keep.data_ptr(), keep.numel(), y.data_ptr(), m, k, num_heads,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, lib)
    head_compact_matmul_pallas.launches += 1
    return y


head_compact_matmul_pallas.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_cuda_library("head_compact_matmul")
    if lib.head_compact_matmul.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.head_compact_operand_pass.argtypes = [
            p, i64, i64, i, p, i64, i, i, p]
        lib.head_compact_matmul.argtypes = [
            p, i64, p, i64, p, i, p, i, i, i, i, p]
        for fn in (lib.head_compact_operand_pass, lib.head_compact_matmul):
            fn.restype = ctypes.c_int
        lib.head_compact_matmul_error_string.argtypes = [ctypes.c_int]
        lib.head_compact_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, lib) -> None:
    if rc != 0:
        msg = lib.head_compact_matmul_error_string(rc).decode()
        raise RuntimeError(f"head_compact_matmul kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
