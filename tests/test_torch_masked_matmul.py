"""The port's masked matmul (crvqa_tpu_torch/ops/masked_matmul.py) vs the
JAX package's Pallas kernels, run interpreted on the CPU. Inputs are made
with numpy from a seed and fed to both.

Both sides round every operand to bf16 and sum the products in fp32, so
they differ only in summation order: fp32 results are held to 1e-5 of the
largest output; results rounded to bf16 (x, or w for ds, in bf16) to one
bf16 step (2^-7 relative) plus that. w's and the threshold's gradients are
exactly zero, and a score on the fp32 side of a bf16-rounded threshold
keeps its weight, bit for bit.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.ops import masked_matmul as jmm
from crvqa_tpu_torch.ops import masked_matmul as tmm
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

SHAPES = [(256, 256, 256), (300, 130, 520), (8, 500, 64)]
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("bfloat16", "float32"), ("float32", "bfloat16")]
THRESHOLD = 0.5


def _inputs(m, k, n, x_dtype, w_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    s = rng.random((k, n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, w_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    return (jx, jw, jnp.asarray(s), jnp.asarray(g).astype(jx.dtype)), (
        tx, tw, torch.from_numpy(s), torch.from_numpy(g).to(tx.dtype))


def _close(got: torch.Tensor, want, bf16: bool, what: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7 if bf16 else 0.0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("x_dtype,w_dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_forward_matches_the_pallas_kernel(m, k, n, x_dtype, w_dtype):
    (jx, jw, js, _), (tx, tw, ts, _) = _inputs(m, k, n, x_dtype, w_dtype)
    want = jmm.masked_matmul(jx, jw, js, jnp.float32(THRESHOLD), True)
    got = tmm.masked_matmul(tx, tw, ts, THRESHOLD)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    _close(got, want, x_dtype == "bfloat16", "forward")


@pytest.mark.parametrize("m,k,n,x_dtype,w_dtype", [
    (300, 130, 520, "float32", "float32"),
    (300, 130, 520, "bfloat16", "bfloat16"),
    (8, 500, 64, "bfloat16", "float32")])
def test_gradients_match_the_pallas_kernels(m, k, n, x_dtype, w_dtype):
    """dx and the STE dscores through the custom VJP's kernels; zeros for
    w and the threshold."""
    (jx, jw, js, jg), (tx, tw, ts, tg) = _inputs(m, k, n, x_dtype, w_dtype,
                                                 seed=1)
    t = jnp.float32(THRESHOLD)
    _, vjp = jax.vjp(lambda x, w, s, t: jmm.masked_matmul(x, w, s, t, True),
                     jx, jw, js, t)
    jdx, jdw, jds, jdt = vjp(jg)

    x = tx.clone().requires_grad_(True)
    w = tw.clone().requires_grad_(True)
    s = ts.clone().requires_grad_(True)
    thr = torch.tensor(THRESHOLD, requires_grad=True)
    y = tmm.masked_matmul(x, w, s, thr)
    dx, dw, ds, dt = torch.autograd.grad(y, (x, w, s, thr), tg)
    assert dx.dtype == tx.dtype and ds.dtype == torch.float32
    _close(dx, jdx, x_dtype == "bfloat16", "dx")
    _close(ds, jds, w_dtype == "bfloat16", "dscores")
    assert float(dw.abs().max()) == 0.0 == float(np.abs(jdw).max())
    assert float(dt) == 0.0 == float(jdt)


def test_plain_versions_agree_with_the_xla_reference():
    """At fp32, bf16 rounding of the operands is the only difference from
    x @ (w ⊙ m) (`masked_matmul_reference`)."""
    (_, _, _, _), (tx, tw, ts, _) = _inputs(64, 96, 80, "float32", "float32",
                                            seed=2)
    got = tmm.masked_matmul_fwd(tx, tw, ts, THRESHOLD)
    ref = tmm.masked_matmul_reference(tx, tw, ts, THRESHOLD)
    bf = tmm.masked_matmul_reference(tx.bfloat16().float(),
                                     tw.bfloat16().float(), ts, THRESHOLD)
    torch.testing.assert_close(got, bf, rtol=0, atol=1e-4)
    assert float((got - ref).abs().max()) > 0  # the rounding is real


def test_bf16_threshold_boundary_matches_the_pallas_kernel():
    """A score above the fp32 threshold but below its bf16 rounding keeps
    its weight: the comparison stays fp32 (masked_matmul.py:112-114)."""
    thr = np.float32(0.01)            # bf16 rounds it up to 0.010009765625
    edge = np.float32(0.0100048)      # > thr, < bf16(thr)
    k = 8
    scores = np.full((k, 128), edge, np.float32)
    want = jmm.masked_matmul(jnp.ones((8, k), jnp.bfloat16),
                             jnp.ones((k, 128), jnp.bfloat16),
                             jnp.asarray(scores), jnp.float32(thr), True)
    got = tmm.masked_matmul(torch.ones(8, k, dtype=torch.bfloat16),
                            torch.ones(k, 128, dtype=torch.bfloat16),
                            torch.from_numpy(scores), float(thr))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert float(got[0, 0]) == k  # the edge scores are kept
    # and a score exactly at the threshold is masked (strict >)
    at = torch.full((k, 128), float(thr))
    assert float(tmm.masked_matmul_fwd(torch.ones(8, k), torch.ones(k, 128),
                                       at, float(thr)).abs().max()) == 0.0


@functools.cache
def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def off_cpu(device, *shape):
    """A tensor that reports `device` and holds no memory (a fake tensor,
    all of one fake mode): a device neither the CPU, `meta` nor a card."""
    from torch._subclasses.fake_tensor import FakeTensor

    return FakeTensor(_fake_mode(), torch.empty(*shape, device="meta"),
                      torch.device(device))


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """No fallback: only a CPU tensor takes the plain version, and a `meta`
    tensor (`utils/mfu.count_flops` counts through it; it launches
    nothing); any other device goes to the kernel path, which refuses what
    is not CUDA."""
    x = off_cpu("xpu", 4, 8)
    w = off_cpu("xpu", 8, 16)
    for call in (lambda: tmm.masked_matmul_fwd(x, w, w, 0.5),
                 lambda: tmm.masked_matmul_dx(x @ w, w, w, 0.5, x.dtype),
                 lambda: tmm.masked_matmul_ds(x, x @ w, w),
                 lambda: tmm.operand_pass(w, w, 0.5)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    xm, wm = (torch.empty(t.shape, device="meta") for t in (x, w))
    assert tmm.masked_matmul_fwd(xm, wm, wm, 0.5).device.type == "meta"
    assert tmm.masked_matmul_ds(xm, xm @ wm, wm).shape == wm.shape
    assert (tmm.masked_matmul_fwd.launches, tmm.masked_matmul_dx.launches,
            tmm.masked_matmul_ds.launches, tmm.operand_pass.launches) == (
                0, 0, 0, 0)


# ------------------------------------------- the operand pass and routes

@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_operand_pass_plain_version_at_the_threshold_edges(w_dtype):
    """The operand pass's plain version is the TPU kernel's `(w * mask)
    .astype(bf16)` (`_fwd_kernel` :57-58) bit for bit: a score equal to
    the threshold is masked, one fp32 step above it kept, and a masked
    negative weight keeps its sign (-0.0)."""
    rng = np.random.default_rng(4)
    thr = np.float32(0.3)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    s = rng.random((24, 40)).astype(np.float32)
    s[::3, ::2] = thr
    s[1::3, ::2] = np.nextafter(thr, np.float32(1))
    s[2::3, ::2] = np.nextafter(thr, np.float32(0))
    jw = jnp.asarray(w).astype(getattr(jnp, w_dtype))
    mask = (jnp.asarray(s) > jnp.float32(thr)).astype(jw.dtype)
    want = np.asarray((jw * mask).astype(jnp.bfloat16)).view(np.int16)
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    for got in (tmm.operand_pass_reference(tw, torch.from_numpy(s), thr),
                tmm.operand_pass(tw, torch.from_numpy(s), float(thr))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)
    at = torch.from_numpy(s) == float(thr)
    got = tmm.operand_pass_reference(tw, torch.from_numpy(s), thr)
    assert not got[at].any()
    assert torch.equal(got[1::3, ::2], tw[1::3, ::2].bfloat16())
    assert (got[at & (tw < 0)].view(torch.int16) == -32768).all()  # -0.0
    # copy mode: bf16(t), whatever t's strides
    assert torch.equal(tmm.operand_pass(tw.T), tw.T.bfloat16())


def _route_case(case):
    base = torch.zeros(64, 776, dtype=torch.bfloat16)[:, :768]
    return {
        "bf16": base,
        "fp32": torch.zeros(64, 768),
        "fp16": torch.zeros(64, 768, dtype=torch.float16),
        "transposed": torch.zeros(768, 64, dtype=torch.bfloat16).T,
        "column_slice": base[:, 128:256],
        "offset_2_bytes": base[:, 1:],
        "offset_16_bytes": base[:, 8:],
        "row_offset": base[3:],
        "rows_1400_bytes": torch.zeros(1000, 700, dtype=torch.bfloat16),
        "one_row_1400_bytes": torch.zeros(1, 700, dtype=torch.bfloat16),
        "inner_stride_2": base[:, ::2],
        "three_dims": torch.zeros(2, 8, 64, dtype=torch.bfloat16),
    }[case]


@pytest.mark.parametrize("case,ready", [
    ("bf16", True), ("fp32", False), ("fp16", False), ("transposed", False),
    ("column_slice", True), ("offset_2_bytes", False),
    ("offset_16_bytes", True), ("row_offset", True),
    ("rows_1400_bytes", False), ("one_row_1400_bytes", True),
    ("inner_stride_2", False), ("three_dims", False)])
def test_route_takes_only_what_tma_reads_in_place(case, ready):
    """`_tma_ready` decides from dtype, strides, shape and address alone:
    bf16 rows with unit inner stride, a row pitch and a start on the
    16-byte grid; anything else goes through the operand pass, whose copy
    always is ready."""
    t = _route_case(case)
    assert tmm._tma_ready(t) is ready
    if t.dim() == 2:
        copy = tmm.operand_pass(t) if t.dtype != torch.float16 else None
        if ready:
            assert tmm._pitch(t) % 8 == 0 and tmm._pitch(t) >= t.shape[1]
        if copy is not None:
            assert copy.dtype == torch.bfloat16 and copy.shape == t.shape


@pytest.mark.parametrize("m,k,n", [(9216, 768, 768), (4096, 768, 3072),
                                   (1000, 700, 300), (1, 1, 1),
                                   (65, 127, 129)])
def test_ds_launch_plan_covers_the_rows_once_within_a_wave(m, k, n):
    """ds's plan: the splits cover the M rows exactly once, in order, each
    non-empty and starting on a reduction step; tiles x splits stay within
    one wave of resident blocks (132 SMs, as the H100 has)."""
    sms = 132
    plan = tmm.ds_plan(m, k, n, sms)
    ranges = plan.row_ranges(m)
    assert len(ranges) == plan.splits <= tmm.MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(a < b and a % tmm.TILE[2] == 0 for a, b in ranges)
    assert plan.tiles == -(-k // tmm.TILE[0]) * -(-n // tmm.TILE[1])
    assert plan.tiles * plan.splits <= max(plan.tiles,
                                           sms * tmm.BLOCKS_PER_SM)
    if (m, k, n) == (9216, 768, 768):  # 36 tiles: 7 splits of 21 steps
        assert (plan.tiles, plan.splits, plan.chunk) == (36, 7, 21)


@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
def test_vjp_hands_ds_a_bf16_cotangent_as_it_is(w_dtype):
    """The VJP's bf16-g route gives the fp32-g route's ds bit for bit
    (bf16 -> fp32 -> bf16 is exact), within the file's tolerance of the
    JAX `_mm_bwd`."""
    (jx, jw, js, jg), (tx, tw, ts, tg) = _inputs(96, 72, 80, "bfloat16",
                                                 w_dtype, seed=5)
    assert tg.dtype == torch.bfloat16
    s = ts.clone().requires_grad_(True)
    y = tmm.masked_matmul(tx, tw, s, THRESHOLD)
    (ds,) = torch.autograd.grad(y, (s,), tg)
    old = tmm.masked_matmul_ds(tx, tg.float(), tw)
    assert torch.equal(ds, old)
    assert torch.equal(tmm.masked_matmul_ds(tx, tg, tw), old)
    t = jnp.float32(THRESHOLD)
    _, vjp = jax.vjp(lambda x, w, s, t: jmm.masked_matmul(x, w, s, t, True),
                     jx, jw, js, t)
    _close(ds, vjp(jg)[2], w_dtype == "bfloat16", "dscores")
