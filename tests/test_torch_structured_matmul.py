"""The port's head-compact matmuls (crvqa_tpu_torch/ops/structured_matmul.py)
vs the JAX package's: `expand_keep_idx` exactly, `head_compact_matmul`
forward and its dense masked backward (fp32, both sides summing the same
products in another order: 1e-5), and the plain version of the kernel
against the Pallas kernel run interpreted (both round x and wt to bf16 and
sum in fp32: 1e-5 of the largest output), with odd kept counts, pad
sentinels, unordered keep lists, an all-masked mask and M, K off the
64-grid; the rounding pass's plain version bit-equal to JAX's bf16 cast,
and which operands the wrapper rounds. Inputs are made with numpy from a
seed.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.ops import structured_matmul as jsm
from crvqa_tpu_torch.ops import structured_matmul as tsm
from tests.test_torch_masked_matmul import off_cpu
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

H, HS, K, M = 6, 64, 256, 256
MASKS = {"some": [1, 0, 1, 0, 0, 1], "all_kept": [1] * H,
         "none_kept": [0] * H}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, H * HS)) * 0.05).astype(np.float32)
    g = rng.normal(size=(M, H * HS)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("n_keep", [1, 3, 5, 6])
@pytest.mark.parametrize("mask", list(MASKS))
def test_expand_keep_idx_matches(mask, n_keep):
    hm = np.asarray(MASKS[mask], bool)
    want = np.asarray(jsm.expand_keep_idx(jnp.asarray(hm), n_keep))
    got = tsm.expand_keep_idx(torch.from_numpy(hm), n_keep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask,extra", [("some", 0), ("some", 2),
                                        ("none_kept", 2)])
def test_head_compact_matmul_forward_and_backward(mask, extra):
    """The XLA-side op: compact forward equal to the dense masked product,
    the dense masked backward (masked head columns of w get zero)."""
    x, w, g = _data(1)
    hm = np.asarray(MASKS[mask], bool)
    n_keep = int(hm.sum()) + extra
    jkeep = jsm.expand_keep_idx(jnp.asarray(hm), n_keep)
    y, vjp = jax.vjp(lambda x, w: jsm.head_compact_matmul(x, w, jkeep, H, HS),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    keep = tsm.expand_keep_idx(torch.from_numpy(hm), n_keep)
    ty = tsm.head_compact_matmul(tx, tw, keep, H, HS)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
    for got, want, what in ((ty, y, "y"), (tdx, jdx, "dx"), (tdw, jdw, "dw")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=what)
    dense = tsm.dense_masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(hm), HS)
    torch.testing.assert_close(ty.detach(), dense, rtol=1e-5, atol=1e-5)
    dropped = torch.from_numpy(~np.repeat(hm, HS))
    assert not ty.detach()[:, dropped].any()
    assert not tdw[:, dropped].any()


# keep lists of the kernel's plain version: the keep list (or the mask and
# the pads `expand_keep_idx` adds), x's dtype, and M, K with the JAX
# function's tiles bm, bk, which must divide them
KERNEL_CASES = {
    "kept3_fp32": (("some", 0), "float32", M, K, 128, 128),
    "kept3_pad3_bf16": (("some", 3), "bfloat16", M, K, 128, 128),
    "all_kept_bf16": (("all_kept", 0), "bfloat16", M, K, 128, 128),
    "none_kept_pad2_fp32": (("none_kept", 2), "float32", M, K, 128, 128),
    "kept1_bf16": (("one", 0), "bfloat16", M, K, 128, 128),
    "kept5_pad1_fp32": (("five", 1), "float32", M, K, 128, 128),
    "unordered_pad_inside_bf16": ([4, 1, H, 2], "bfloat16", M, K, 128, 128),
    "unordered_fp32_m72_k200": ([5, 0, 3], "float32", 72, 200, 72, 200),
    "kept3_bf16_m40_k24": (("some", 1), "bfloat16", 40, 24, 8, 8),
}
MASKS.update({"one": [0, 0, 0, 1, 0, 0], "five": [1, 1, 0, 1, 1, 1]})


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_plain_version_matches_the_pallas_kernel(case):
    """wt [N, K] read per kept head; odd kept counts leave half a slot
    pair to a pad; pads (the sentinel H, also between kept heads) dropped,
    every other column zero; keep lists in any order; output in x's
    dtype."""
    spec, dtype, m, k, bm, bk = KERNEL_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, H * HS)) * 0.05).astype(np.float32)
    if isinstance(spec, tuple):
        hm = np.asarray(MASKS[spec[0]], bool)
        keep = np.asarray(tsm.expand_keep_idx(torch.from_numpy(hm),
                                              int(hm.sum()) + spec[1]))
    else:
        keep = np.asarray(spec)
    kept = [h for h in keep if h < H]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jsm.head_compact_matmul_pallas(
        jx, jnp.asarray(w.T), jnp.asarray(keep, jnp.int32), H, HS, bm=bm,
        bk=bk, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tsm.head_compact_matmul_pallas(
        tx, torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(keep), H, HS, bm=bm, bk=bk)
    assert got.dtype == tx.dtype and got.shape == (m, H * HS)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=2.0 ** -7 if dtype == "bfloat16"
        else 0.0, atol=1e-5 * max(float(np.abs(want).max()), 1.0))
    dropped = ~np.isin(np.repeat(np.arange(H), HS), kept)
    assert not got[:, torch.from_numpy(dropped)].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operand_pass_plain_version_is_bf16_rounding(dtype):
    """The rounding pass's plain version gives the bits of JAX's
    `astype(jnp.bfloat16)` (round to nearest even), ties, signed zeros,
    infinities and subnormals included; a bf16 operand is copied as it
    is."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(16, 40)).astype(np.float32)
    bits = base.view(np.uint32)
    bits[0, :8] = (bits[0, :8] & 0xFFFF0000) | 0x8000  # exact ties
    bits[1, :8] = (bits[1, :8] & 0xFFFF0000) | 0x8001  # just past a tie
    base[2, :6] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39]
    base[3, :2] = [3.4e38, -3.39e38]
    jt = jnp.asarray(base).astype(getattr(jnp, dtype))
    want = np.asarray(jt.astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.from_numpy(base).to(getattr(torch, dtype))
    for got in (tsm.operand_pass_reference(t), tsm.operand_pass(t),
                tsm.operand_pass(t.T).T):
        assert got.dtype == torch.bfloat16 and got.shape == t.shape
        np.testing.assert_array_equal(
            got.float().numpy().view(np.uint32), want.view(np.uint32))


def _aligned_bf16(rows, cols, pitch, offset=0):
    buf = torch.zeros(rows * pitch + offset + 8, dtype=torch.bfloat16)
    start = offset + (-buf.data_ptr() // 2) % 8  # on the 16-byte grid
    return buf[start:start + rows * pitch].view(rows, pitch)[:, :cols]


@pytest.mark.parametrize("layout,rounded", [
    ("bf16", False), ("fp32", True), ("bf16_row_slice", False),
    ("bf16_transposed", True), ("bf16_pitch_not_8", True),
    ("bf16_misaligned_start", True), ("bf16_one_row", False)])
def test_rounded_operands_routes_what_tma_cannot_read(layout, rounded):
    """The wrapper rounds x or wt through the operand pass exactly when the
    kernel's TMA cannot read it in place: fp32, a transposed view, a row
    pitch off the 16-byte grid or a misaligned start."""
    t = {"bf16": lambda: _aligned_bf16(64, 96, 96),
         "fp32": lambda: torch.zeros(64, 96),
         "bf16_row_slice": lambda: _aligned_bf16(64, 96, 136),
         "bf16_transposed": lambda: _aligned_bf16(96, 64, 64).T,
         "bf16_pitch_not_8": lambda: _aligned_bf16(64, 90, 90),
         "bf16_misaligned_start": lambda: _aligned_bf16(64, 96, 96, 1),
         "bf16_one_row": lambda: _aligned_bf16(1, 90, 90)}[layout]()
    ok = _aligned_bf16(64, 96, 96)
    assert tsm.rounded_operands(t, ok) == (rounded, False)
    assert tsm.rounded_operands(ok, t) == (False, rounded)


def test_kernel_preconditions_and_devices():
    x = torch.zeros(M, K)
    wt = torch.zeros(H * HS, K)
    keep = torch.arange(2)
    with pytest.raises(ValueError, match="multiples"):
        tsm.head_compact_matmul_pallas(x, wt, keep, H, HS, bm=512)
    with pytest.raises(ValueError, match="is not"):
        tsm.head_compact_matmul_pallas(x, wt[:-1], keep, H, HS, bm=128)
    with pytest.raises(ValueError, match="unsupported devices"):
        tsm.head_compact_matmul_pallas(off_cpu("xpu", M, K),
                                       off_cpu("xpu", H * HS, K), keep, H,
                                       HS, bm=128, bk=128)
    with pytest.raises(ValueError, match="unsupported devices"):
        tsm.head_compact_matmul_pallas(x, wt.to("meta"), keep, H, HS, bm=128,
                                       bk=128)
    # `meta` (utils/mfu.count_flops) takes the plain version, as the CPU
    assert tsm.head_compact_matmul_pallas(
        x.to("meta"), wt.to("meta"), keep, H, HS, bm=128,
        bk=128).device.type == "meta"
    assert tsm.head_compact_matmul_pallas.launches == 0
    assert tsm.operand_pass.launches == 0
