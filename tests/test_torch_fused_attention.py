"""The port's fused attention (crvqa_tpu_torch/ops/fused_attention.py) vs
the JAX package's Pallas kernel, run interpreted on the CPU, and its XLA
reference. Inputs are made with numpy from a seed and fed to both.

fp32 throughout, atol 1e-5: both sides compute scores and softmax in fp32
and differ only in summation order.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crvqa_tpu.ops import fused_attention as jfa
from crvqa_tpu_torch.ops import fused_attention as tfa

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


def test_dropout_rate_raises():
    q, k, v, bias = _torch(*_inputs(2, 14, 14, 12, 64))
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa.fused_attention(q, k, v, bias, 12, 64, rate=0.1)


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
