"""The port's mid-length attention (crvqa_tpu_torch/ops/midseq_attention.py)
vs the JAX package's Pallas kernel, run interpreted on the CPU. Inputs are
made with numpy from a seed and fed to both.

In fp32 outputs agree within atol 1e-5 and autograd's gradients within
2e-5 (both sides compute scores and softmax in fp32 and differ only in
summation order). The plain recompute backward is held against `jax.vjp`
through the interpreted `_bwd_kernel`: fp32 within atol 1e-5, bf16 within
2e-2 (one bf16 rounding of p, ds and each output on gradients of size about
1). The dropout keep mask is compared bit for bit.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.ops import fused_attention as jfa
from crvqa_tpu.ops import midseq_attention as jma
from crvqa_tpu_torch.ops import midseq_attention as tma
from tests.test_torch_masked_matmul import off_cpu
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

# (sq, sk, h, d): both TPU pad dims; (29, 77, 3, 40) has no 128-aligned
# head group (the TPU kernel takes all heads in one program)
SHAPES = [(37, 133, 2, 64), (16, 256, 2, 64), (133, 133, 4, 32),
          (29, 77, 3, 40)]


def _inputs(sq, sk, h, d, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, sq, h * d)).astype(np.float32)
    k = rng.normal(size=(batch, sk, h * d)).astype(np.float32)
    v = rng.normal(size=(batch, sk, h * d)).astype(np.float32)
    bias = np.zeros((batch, sk), np.float32)
    for i in range(1, batch):  # -10000 pads on the tail keys
        bias[i, sk - 2 * i:] = -10000.0
    return q, k, v, bias


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 1234), (0.1, -5)])
@pytest.mark.parametrize("sq,sk,h,d", SHAPES)
def test_plain_matches_jax_kernel(sq, sk, h, d, rate, seed):
    q, k, v, bias = _inputs(sq, sk, h, d, seed=sq + sk + h)
    want = np.asarray(jma.midseq_attention_seeded(
        *_jax(q, k, v, bias), jnp.asarray([seed], jnp.int32), h, d, rate,
        True))
    got = tma.midseq_attention(*_torch(q, k, v, bias), h, d, rate, seed)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 7, -1, -2 ** 31, 2 ** 31 - 1])
def test_keep_mask_bit_identical_to_jax(seed, rate):
    """Keyed on the global batch row, the absolute head and the plain key
    index: `_keep_mask(p.shape, rate, seed, b, h)` of the TPU kernel."""
    for b in (0, 1, 13):
        for h in (0, 1, 11):
            for sq, sk in ((37, 133), (1, 602), (5, 48)):
                want = np.asarray(jfa._keep_mask((sq, sk), rate,
                                                 jnp.int32(seed), b, h))
                got = tma.keep_mask(torch.tensor([b]), sq, sk, rate, seed,
                                    head=h)[0]
                np.testing.assert_array_equal(got.numpy(), want)


def test_drop_factor_matches_keep_mask_per_head():
    f = tma.drop_factor(2, 3, 5, 7, 0.25, -9, "cpu")
    for b in range(2):
        for h in range(3):
            keep = tma.keep_mask(torch.tensor([b]), 5, 7, 0.25, -9,
                                 head=h)[0]
            assert torch.equal(f[b, h], torch.where(keep, 1 / 0.75, 0.0))


def test_supported_equals_jax():
    for batch in (1, 8, 32):
        for sq in (1, 25, 120, 577, 602, 900, 1200):
            for sk in (77, 577, 602, 900, 1200):
                for h, d in ((12, 64), (16, 64), (3, 40), (8, 32)):
                    for item in (2, 4):
                        assert tma.supported(batch, sq, sk, h, d, item) == \
                            jma.supported(batch, sq, sk, h, d, item), \
                            (batch, sq, sk, h, d, item)
    for h, d in ((12, 64), (3, 40), (8, 32), (16, 64), (2, 64)):
        assert tma._pick_hg(h, d) == jma._pick_hg(h, d)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,h,d", [(37, 133, 2, 64), (29, 77, 3, 40)])
def test_autograd_matches_jax_recompute_backward(sq, sk, h, d, rate):
    """The plain version under autograd against jax.grad through the
    interpreted TPU forward and its recompute backward (`_bwd_kernel`):
    the gradient contract the training slice's kernel will keep."""
    q, k, v, bias = _inputs(sq, sk, h, d, seed=3)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    seed = -77

    def loss(q_, k_, v_):
        out = jma.midseq_attention_seeded(
            q_, k_, v_, jnp.asarray(bias), jnp.asarray([seed], jnp.int32),
            h, d, rate, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax(q, k, v))
    leaves = [t.requires_grad_() for t in _torch(q, k, v)]
    out = tma.midseq_attention(*leaves, torch.from_numpy(bias), h, d, rate,
                               seed)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=f"d{name}")


def _jax_vjp(q, k, v, bias, g, h, d, rate, seed, dtype):
    qj, kj, vj = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    _, vjp = jax.vjp(
        lambda a, b, c: jma.midseq_attention_seeded(
            a, b, c, jnp.asarray(bias), jnp.asarray([seed], jnp.int32), h, d,
            rate, True), qj, kj, vj)
    return [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g).astype(dtype))]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,h,d", [(37, 133, 2, 64), (25, 77, 3, 64),
                                       (133, 131, 2, 64), (29, 77, 3, 40)])
def test_plain_backward_matches_jax_vjp(sq, sk, h, d, rate, dtype, atol):
    """`midseq_attention_bwd_reference` (the arithmetic the CUDA backward
    repeats) against the interpreted TPU backward, odd Sq and Sk."""
    q, k, v, bias = _inputs(sq, sk, h, d, seed=sq + sk)
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    seed = -1234
    want = _jax_vjp(q, k, v, bias, g, h, d, rate, seed, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (t.to(tdt) for t in _torch(q, k, v))
    got = tma.midseq_attention_bwd(tq, tk, tv, torch.from_numpy(bias),
                                   torch.from_numpy(g), h, d, rate, seed)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=atol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_autograd_function_on_cpu_tensors(rate):
    """`MidseqAttentionFunction` (forward, then the recompute backward from
    q, k, v, bias and seed only) gives autograd's gradients of the plain
    forward, launches nothing on the CPU, and hands the bias none."""
    q, k, v, bias = _torch(*_inputs(21, 45, 2, 64, seed=8))
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=q.shape).astype(np.float32))
    before = (tma.midseq_attention.launches,
              tma.midseq_attention_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tma.MidseqAttentionFunction.apply(*leaves, bias, 2, 64, rate, 11)
    got = torch.autograd.grad(out, leaves, g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        tma.midseq_attention(*ref, bias, 2, 64, rate, 11), ref, g)
    assert (tma.midseq_attention.launches,
            tma.midseq_attention_bwd.launches) == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    bias_leaf = bias.clone().requires_grad_()
    out = tma.MidseqAttentionFunction.apply(*leaves, bias_leaf, 2, 64, rate,
                                            11)
    assert torch.autograd.grad(out.sum(), bias_leaf,
                               allow_unused=True)[0] is None


def test_backward_refuses_a_mismatched_cotangent():
    q, k, v, bias = _torch(*_inputs(14, 36, 2, 64))
    with pytest.raises(ValueError, match="does not match"):
        tma.midseq_attention_bwd(q, k, v, bias, q[:, :13], 2, 64)


def test_cpu_wrapper_takes_plain_version_and_launches_nothing():
    q, k, v, bias = _torch(*_inputs(25, 77, 12, 64))
    before = tma.midseq_attention.launches
    out = tma.midseq_attention(q, k, v, bias, 12, 64, 0.1, 3)
    assert tma.midseq_attention.launches == before
    assert torch.equal(out, tma.midseq_attention_reference(
        q, k, v, bias, 12, 64, 0.1, 3))


def test_column_slices_of_one_projection():
    """The ViT hands q, k, v as column slices of one fused [B, S, 3*H*D]
    projection: the result equals that of contiguous copies."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 40, 3 * 64)).astype(
        np.float32))
    q, k, v = qkv.chunk(3, dim=-1)
    bias = torch.zeros(2, 40)
    a = tma.midseq_attention(q, k, v, bias, 2, 32)
    b = tma.midseq_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             bias, 2, 32)
    assert torch.equal(a, b)


def test_non_cpu_tensor_needing_a_gradient_raises():
    """Off the CPU (and `meta`, which `utils/mfu.count_flops` counts
    through) the wrapper never takes the plain version: with or without a
    gradient to compute, the call goes to the kernel checks, which refuse
    a device other than CUDA; so does the backward."""
    q, k, v = (off_cpu("xpu", 2, 30, 128) for _ in range(3))
    bias = off_cpu("xpu", 2, 30)
    with pytest.raises(ValueError, match="unsupported device"):
        tma.midseq_attention(q.requires_grad_(), k, v, bias, 2, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        tma.midseq_attention(q.detach(), k, v, bias, 2, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        tma.midseq_attention_bwd(q.detach(), k, v, bias, q.detach(), 2, 64)


def test_mismatched_shapes_raise():
    q, k, v, bias = _torch(*_inputs(14, 36, 2, 64))
    with pytest.raises(ValueError, match="do not agree"):
        tma.midseq_attention(q, k, v, bias[:, :14], 2, 64)
    with pytest.raises(ValueError, match="dropout"):
        tma.midseq_attention(q, k, v, bias, 2, 64, rate=1.0)


def _bf16(shape, cols=None):
    """A bf16 CPU tensor [B, S, 768], or column slice [..., cols] of a wider
    one."""
    if cols is None:
        return torch.zeros(shape, dtype=torch.bfloat16)
    return torch.zeros(*shape[:2], cols.stop + 8,
                       dtype=torch.bfloat16)[..., cols]


# (case, dtype, q, k, g or None, accepted): what the kernels' argument
# checks accept and refuse. bf16 stages 16 bytes a thread and has no Sk
# bound; fp32 reads elements and keeps a shared-memory row of Sk floats.
CHECK_CASES = [
    ("vit_qkv_slices", torch.bfloat16, slice(0, 768), slice(768, 1536),
     False, True),
    ("bf16_4096_keys", torch.bfloat16, None, "4096", False, True),
    ("bf16_bwd_4096_keys", torch.bfloat16, None, "4096", True, True),
    ("bf16_start_off_grid", torch.bfloat16, slice(1, 769), None, False,
     False),
    ("bf16_g_start_off_grid", torch.bfloat16, None, None, "off", False),
    ("bf16_row_stride", torch.bfloat16, None, "stride", False, False),
    ("fp32_start_off_grid", torch.float32, slice(1, 769), None, False, True),
    ("fp32_4096_keys", torch.float32, None, "4096", False, False),
    ("fp32_bwd_2048_keys", torch.float32, None, "2048", True, False),
]


@pytest.mark.parametrize("case,dtype,qcols,kcase,gcase,accepted",
                         CHECK_CASES, ids=[c[0] for c in CHECK_CASES])
def test_kernel_checks_by_dtype(case, dtype, qcols, kcase, gcase, accepted):
    """`_check_kernel_args`, which the CUDA wrappers call before a launch,
    on CPU tensors of the shapes the card would get."""
    sk = {"4096": 4096, "2048": 2048}.get(kcase, 577)
    q = _bf16((2, 25, 768), qcols).to(dtype)
    if kcase == "stride":  # rows of 772 elements
        k = torch.zeros(2, sk, 772, dtype=dtype)[..., :768]
    elif isinstance(kcase, slice):
        k = _bf16((2, sk, 768), kcase).to(dtype)
    else:
        k = torch.zeros(2, sk, 768, dtype=dtype)
    bias = torch.zeros(2, sk)
    g = None
    if gcase:
        g = (_bf16((2, 25, 768), slice(1, 769)).to(dtype) if gcase == "off"
             else torch.zeros_like(q))
    if accepted:
        tma._check_kernel_args(q, k, k, bias, 64, g)
    else:
        with pytest.raises(ValueError, match="16-byte|shared memory"):
            tma._check_kernel_args(q, k, k, bias, 64, g)


def test_unused_strides_of_size_one_dimensions_are_zero():
    """A batch or row of one is never stepped over: the kernels get stride
    0 there, so an odd stride there does not refuse the bf16 kernels."""
    q = torch.zeros(1, 1, 777, dtype=torch.bfloat16)[..., :768]
    assert tma._strides(q) == (0, 0)
    assert tma._tiles_aligned(q)
    k = torch.zeros(1, 5, 776, dtype=torch.bfloat16)[..., :768]
    assert tma._strides(k) == (0, 776) and tma._tiles_aligned(k)
    tma._check_kernel_args(q, k, k, torch.zeros(1, 5), 64)
