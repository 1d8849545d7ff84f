"""The port's fused attention (crvqa_tpu_torch/ops/fused_attention.py) vs
the JAX package's Pallas kernels, run interpreted on the CPU, and its XLA
reference. Inputs are made with numpy from a seed and fed to both.

fp32 throughout, atol 1e-5 (outputs) and 2e-5 (gradients): both sides
compute scores and softmax in fp32 and differ only in summation order.
The dropout keep mask is compared bit for bit.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.ops import fused_attention as jfa
from crvqa_tpu_torch.ops import fused_attention as tfa
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

SHAPES = [(14, 14), (36, 36), (14, 36), (36, 14)]
HEADS = [(12, 64), (4, 16)]


def _inputs(b, sq, sk, h, d, seed=0, pad=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h * d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h * d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h * d)).astype(np.float32)
    bias = np.zeros((b, sk), np.float32)
    if pad:  # -10000 pads on the tail keys of every row but the first
        for i in range(1, b):
            bias[i, sk - 1 - i * (sk // 4):] = -10000.0
    return q, k, v, bias


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("h,d", HEADS)
@pytest.mark.parametrize("sq,sk", SHAPES)
def test_plain_matches_jax_kernel_and_reference(sq, sk, h, d):
    q, k, v, bias = _inputs(3, sq, sk, h, d, seed=sq * 100 + sk + h)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    kernel = np.asarray(jfa.fused_attention(*jargs, h, d, 0.0, True))
    ref = np.asarray(jfa.reference_attention(*jargs, h, d))
    ours = tfa.fused_attention_reference(*_torch(q, k, v, bias), h, d).numpy()
    np.testing.assert_allclose(ours, kernel, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_cpu_wrapper_takes_plain_version_and_launches_nothing():
    q, k, v, bias = _torch(*_inputs(2, 14, 36, 12, 64))
    before = tfa.fused_attention.launches
    out = tfa.fused_attention(q, k, v, bias, 12, 64)
    assert tfa.fused_attention.launches == before
    assert torch.equal(out, tfa.fused_attention_reference(q, k, v, bias,
                                                          12, 64))


@pytest.mark.parametrize("rate", [1.0, -0.1])
def test_dropout_rate_raises(rate):
    """Dropout is ported; a rate outside [0, 1) is refused."""
    q, k, v, bias = _torch(*_inputs(2, 14, 14, 12, 64))
    with pytest.raises(ValueError, match="dropout"):
        tfa.fused_attention(q, k, v, bias, 12, 64, rate=rate)
    with pytest.raises(ValueError, match="dropout"):
        tfa.fused_attention_fwd_train(q, k, v, bias, 12, 64, rate, 0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 7, -1, -2 ** 31, 2 ** 31 - 1])
def test_keep_mask_bit_identical_to_jax(seed, rate):
    for b in (0, 1, 13, 255):
        for sq, cols in ((14, 12 * 14), (36, 12 * 36), (5, 48)):
            want = np.asarray(jfa._keep_mask((sq, cols), rate,
                                             jnp.int32(seed), b, 0))
            got = tfa.keep_mask(torch.tensor([b]), sq, cols, rate, seed)[0]
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sq,sk", [(14, 36), (36, 14)])
def test_dropout_forward_matches_jax_kernel(sq, sk):
    """rate 0.1 with a negative seed: the interpreted JAX kernel's primal,
    and its forward for grad's residual, against the port."""
    q, k, v, bias = _inputs(3, sq, sk, 4, 16, seed=sq + sk)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    seed = jnp.asarray([-5], jnp.int32)
    want = np.asarray(jfa.fused_attention_seeded(*jargs, seed, 4, 16, 0.1,
                                                 True))
    got = tfa.fused_attention(*_torch(q, k, v, bias), 4, 16, rate=0.1,
                              seed=-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    _, res = jfa._fa_fwd(*jargs, 4, 16, 0.1, True, seed)
    out, p = tfa.fused_attention_fwd_train(*_torch(q, k, v, bias), 4, 16,
                                           0.1, -5)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(res[5]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["stored", "recompute"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_gradients_match_jax_kernel(impl, rate, monkeypatch):
    """dq, dk, dv from torch.autograd through the port's autograd function
    against jax.grad through the interpreted Pallas forward-for-grad and
    backward kernels, BWD_IMPL stored and recompute."""
    monkeypatch.setattr(jfa, "BWD_IMPL", impl)
    monkeypatch.setattr(tfa, "BWD_IMPL", impl)
    q, k, v, bias = _inputs(3, 14, 36, 4, 16, seed=3)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    seed = 1234

    def loss(q_, k_, v_):
        out = jfa.fused_attention_seeded(
            q_, k_, v_, jnp.asarray(bias), jnp.asarray([seed], jnp.int32),
            4, 16, rate, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    leaves = [t.requires_grad_() for t in _torch(q, k, v)]
    out = tfa.fused_attention(*leaves, torch.from_numpy(bias), 4, 16, rate,
                              seed)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_reference_equals_autograd_of_plain_forward(rate):
    q, k, v, bias = _torch(*_inputs(2, 36, 14, 4, 16, seed=8))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, p = tfa.fused_attention_train_reference(*leaves, bias, 4, 16, rate,
                                                 77)
    want = torch.autograd.grad(out, leaves, g)
    got = tfa.fused_attention_bwd_reference(q, k, v, p.detach(), g, 4, 16,
                                            rate, 77)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_cpu_training_wrappers_launch_nothing():
    q, k, v, bias = _torch(*_inputs(2, 14, 14, 4, 16))
    counters = (tfa.fused_attention_fwd_train, tfa.fused_attention_bwd_stored,
                tfa.fused_attention_bwd_recompute, tfa.fused_attention)
    before = [c.launches for c in counters]
    leaves = [t.requires_grad_() for t in (q, k, v)]
    tfa.fused_attention(*leaves, bias, 4, 16, 0.1, 3).sum().backward()
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("sq,sk", [(86, 14), (14, 86)])
def test_out_of_scope_shape_raises(sq, sk):
    # 12 heads x 86 = 1032 > 1024: outside the short-sequence scope
    q, k, v, bias = _torch(*_inputs(1, sq, sk, 12, 64, pad=False))
    with pytest.raises(ValueError, match="short-sequence scope"):
        tfa.fused_attention(q, k, v, bias, 12, 64)


def test_mismatched_shapes_raise():
    q, k, v, bias = _torch(*_inputs(2, 14, 36, 12, 64))
    with pytest.raises(ValueError, match="do not agree"):
        tfa.fused_attention(q, k, v, bias[:, :14], 12, 64)


# The edge shapes the card's bf16 kernels are held to their plain versions
# at: one query and one key, the longest rows at 12 heads (85 x 12 = 1020),
# and stage 3's compacted 6 heads. Tiny head size: the plain versions are
# what is compared here.
EDGE = [(12, 1, 1), (12, 85, 85), (6, 36, 36)]


@pytest.mark.parametrize("h,sq,sk", EDGE)
def test_plain_matches_jax_kernel_at_edge_shapes(h, sq, sk):
    q, k, v, bias = _inputs(2, sq, sk, h, 16, seed=sq + sk + h)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    kernel = np.asarray(jfa.fused_attention(*jargs, h, 16, 0.0, True))
    ours = tfa.fused_attention_reference(*_torch(q, k, v, bias), h,
                                         16).numpy()
    np.testing.assert_allclose(ours, kernel, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,sq,sk", EDGE)
def test_dropout_forward_matches_jax_kernel_at_edge_shapes(h, sq, sk):
    """rate 0.1: the interpreted JAX kernel's seeded primal and its
    forward for grad's residual against the port's plain versions."""
    q, k, v, bias = _inputs(2, sq, sk, h, 16, seed=3 * sq + sk)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    seed = jnp.asarray([-9], jnp.int32)
    want = np.asarray(jfa.fused_attention_seeded(*jargs, seed, h, 16, 0.1,
                                                 True))
    got = tfa.fused_attention(*_torch(q, k, v, bias), h, 16, rate=0.1,
                              seed=-9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    _, res = jfa._fa_fwd(*jargs, h, 16, 0.1, True, seed)
    _, p = tfa.fused_attention_fwd_train(*_torch(q, k, v, bias), h, 16, 0.1,
                                         -9)
    np.testing.assert_allclose(p.numpy(), np.asarray(res[5]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["stored", "recompute"])
@pytest.mark.parametrize("h,sq,sk", EDGE)
def test_gradients_match_jax_kernel_at_edge_shapes(h, sq, sk, impl,
                                                   monkeypatch):
    """dq, dk, dv at rate 0.1 through both backwards against jax.grad
    through the interpreted Pallas kernels."""
    monkeypatch.setattr(jfa, "BWD_IMPL", impl)
    monkeypatch.setattr(tfa, "BWD_IMPL", impl)
    q, k, v, bias = _inputs(2, sq, sk, h, 16, seed=sq * sk + h)
    g = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        out = jfa.fused_attention_seeded(
            q_, k_, v_, jnp.asarray(bias), jnp.asarray([77], jnp.int32),
            h, 16, 0.1, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    leaves = [t.requires_grad_() for t in _torch(q, k, v)]
    out = tfa.fused_attention(*leaves, torch.from_numpy(bias), h, 16, 0.1,
                              77)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=f"d{name}")


_LIMIT = 232448  # bytes of shared memory a Hopper block may use


def _in_scope(min_heads=1):
    """Every (H, Sq, Sk) of the short-sequence scope with H >= min_heads
    (H*Sq, H*Sk <= 1024)."""
    for h in range(min_heads, 1025):
        for sq in range(1, 1024 // h + 1):
            for sk in range(1, 1024 // h + 1):
                yield h, sq, sk


@pytest.mark.parametrize("stored", [True, False])
def test_bwd_smem_bf16_fits_every_shape_the_fp32_kernel_takes(stored):
    """The bf16 backward takes every shape the fp32 (and the earlier
    scalar bf16) kernel took: its block fits 227 KB wherever theirs did."""
    seen = set()
    for _, sq, sk in _in_scope():
        if (sq, sk) in seen:
            continue
        seen.add((sq, sk))
        if tfa.bwd_smem_bytes(sq, sk, torch.float32, stored) <= _LIMIT:
            assert tfa.bwd_smem_bytes(sq, sk, torch.bfloat16,
                                      stored) <= _LIMIT, (sq, sk)


@pytest.mark.parametrize("stored", [True, False])
def test_bwd_smem_bf16_fits_every_shape_at_twelve_heads(stored):
    """At LXMERT's and mPLUG's 12 heads every in-scope shape fits, and at
    (36, 36) at least two blocks fit an SM."""
    for _, sq, sk in _in_scope(min_heads=12):
        if sq <= 85 and sk <= 85:
            assert tfa.bwd_smem_bytes(sq, sk, torch.bfloat16,
                                      stored) <= _LIMIT, (sq, sk)
    assert 2 * tfa.bwd_smem_bytes(36, 36, torch.bfloat16, stored) <= _LIMIT


def test_bwd_smem_bytes_at_known_shapes():
    """The bf16 plan's bytes (q, g, k rows of 144 bytes; the ds and p_t
    planes; V and the stored p plane or the bias, or the warps' output
    slots if larger) at LXMERT's (36, 36) and stage 3's widest 6-head
    shape, where only the recompute backward fits."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tfa.bwd_smem_bytes(36, 36, bf16, True) == 49152
    assert tfa.bwd_smem_bytes(36, 36, bf16, False) == 38592
    assert tfa.bwd_smem_bytes(1, 1, bf16, False) == 10816
    assert tfa.bwd_smem_bytes(170, 170, bf16, True) > _LIMIT
    assert tfa.bwd_smem_bytes(170, 170, bf16, False) == 231616
    assert tfa.bwd_smem_bytes(36, 36, f32, True) == 4 * (144 * 65 + 3 * 1296)
    assert tfa.bwd_smem_bytes(170, 170, f32, False) > _LIMIT


def test_tiles_aligned_checks_start_and_strides():
    """The bf16 kernels' 16-byte staging: a start off the 16-byte grid, or
    a batch or row stride not a multiple of 8 elements, is refused; the
    stride of a size-1 dimension is never used."""
    base = torch.zeros(2, 36, 3 * 768, dtype=torch.bfloat16)
    assert tfa._tiles_aligned(base[..., 768:1536])
    assert not tfa._tiles_aligned(base[..., 1:769])
    assert not tfa._tiles_aligned(
        torch.zeros(2, 36, 772, dtype=torch.bfloat16)[..., 4:])
    assert not tfa._tiles_aligned(
        torch.zeros(2, 36, 770, dtype=torch.bfloat16)[..., :768])
    assert tfa._tiles_aligned(
        torch.zeros(1, 1, 770, dtype=torch.bfloat16)[..., :768])
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_aligned(base[..., :768], base[..., 1:769])
    tfa._check_aligned(base.float()[..., 1:769])  # fp32: no staging rule
