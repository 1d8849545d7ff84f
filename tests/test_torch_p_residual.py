"""The stored backward's bf16 probability residual (`P_RESIDUAL_DTYPE`)
and `BWD_IMPL = "stored_folddot"` of the port's fused attention
(crvqa_tpu_torch/ops/fused_attention.py) against the JAX package's Pallas
kernels, run interpreted on the CPU, with the same module globals set.
Inputs are made with numpy from a seed and fed to both; fp32 activations.

- The residual itself: the plain forward for grad's p rounded to bf16
  (round to nearest even) equals the fp32 residual rounded, and differs
  from it by at most half a bf16 ulp (2^-8 relative).
- dq, dk, dv with the bf16 residual against the JAX kernels' with theirs,
  at LXMERT's (14, 36) and VisualBERT's (50, 50) at 12 heads, dropout 0
  and 0.1. Both sides round an fp32 p computed in another summation
  order, so an element next to a rounding boundary may go to the
  neighbouring bf16 value on one side, which moves a row of dq and of dk
  by one ulp of p (2^-8 relative) in one term of ds. So: the mean absolute
  difference under 1e-5 of the gradient's mean magnitude (one side
  keeping p in fp32 differs by about 1.5e-3 of it), and the largest under
  2^-8 of the gradient's largest magnitude.
- The bf16 residual's gradients against the fp32 residual's, within
  tests/test_fused_attention.py:365-390's bound: the largest difference
  under 2e-2 of the largest gradient (bf16's ~2^-8 relative rounding).
- "stored_folddot" equals "stored" in the port bit for bit and matches the
  JAX package's "stored_folddot" at tests/test_torch_fused_attention.py's
  gradient tolerance (atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.ops import fused_attention as jfa
from crvqa_tpu_torch.ops import fused_attention as tfa
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

SEED = 1234
HEADS, HEAD_SIZE = 12, 64


def _inputs(b, sq, sk, seed):
    rng = np.random.default_rng(seed)
    d = HEADS * HEAD_SIZE
    q, k, v = (rng.normal(size=(b, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    bias = np.zeros((b, sk), np.float32)
    bias[1, sk - 3:] = -10000.0  # padded keys on one row
    g = rng.normal(size=(b, sq, d)).astype(np.float32)
    return q, k, v, bias, g


def _jax_grads(q, k, v, bias, g, rate):
    def loss(q_, k_, v_):
        out = jfa.fused_attention_seeded(
            q_, k_, v_, jnp.asarray(bias), jnp.asarray([SEED], jnp.int32),
            HEADS, HEAD_SIZE, rate, True)
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))]


def _port_grads(q, k, v, bias, g, rate):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.fused_attention(*leaves, torch.from_numpy(bias), HEADS,
                              HEAD_SIZE, rate, SEED)
    return [x.numpy() for x in torch.autograd.grad(out, leaves,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("sq,sk", [(14, 36), (50, 50)])
def test_residual_is_the_fp32_residual_rounded(sq, sk, monkeypatch):
    q, k, v, bias, _ = (torch.from_numpy(a)
                        for a in _inputs(2, sq, sk, sq + sk))
    args = (q, k, v, bias, HEADS, HEAD_SIZE, 0.1, SEED)
    _, exact = tfa.fused_attention_fwd_train(*args)
    monkeypatch.setattr(tfa, "P_RESIDUAL_DTYPE", torch.bfloat16)
    out, p = tfa.fused_attention_fwd_train(*args)
    assert exact.dtype == torch.float32 and p.dtype == torch.bfloat16
    assert torch.equal(p, exact.to(torch.bfloat16))
    rel = ((p.float() - exact).abs() / exact.abs().clamp_min(1e-30)).max()
    assert float(rel) <= 2.0 ** -8
    # the output does not depend on the residual's type
    monkeypatch.setattr(tfa, "P_RESIDUAL_DTYPE", torch.float32)
    assert torch.equal(out, tfa.fused_attention_fwd_train(*args)[0])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk", [(14, 36), (50, 50)])
def test_bf16_residual_gradients_match_jax(sq, sk, rate, monkeypatch):
    monkeypatch.setattr(jfa, "P_RESIDUAL_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(tfa, "P_RESIDUAL_DTYPE", torch.bfloat16)
    inputs = _inputs(3, sq, sk, 7 * sq + sk)
    want = _jax_grads(*inputs, rate)
    got = _port_grads(*inputs, rate)
    for name, a, b in zip("qkv", got, want):
        diff = np.abs(a - b)
        assert diff.mean() <= 1e-5 * np.abs(b).mean(), (name, diff.mean())
        assert diff.max() <= 2.0 ** -8 * np.abs(b).max(), (name, diff.max())


@pytest.mark.parametrize("sq,sk", [(14, 36), (50, 50)])
def test_bf16_residual_within_bf16_rounding_of_fp32(sq, sk, monkeypatch):
    inputs = _inputs(3, sq, sk, sq * sk)
    exact = _port_grads(*inputs, 0.1)
    monkeypatch.setattr(tfa, "P_RESIDUAL_DTYPE", torch.bfloat16)
    approx = _port_grads(*inputs, 0.1)
    for name, a, b in zip("qkv", approx, exact):
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)
        assert 0 < err < 2e-2, (name, err)


def test_stored_folddot_matches_jax_and_the_stored_backward(monkeypatch):
    inputs = _inputs(3, 14, 36, 3)
    stored = _port_grads(*inputs, 0.1)
    monkeypatch.setattr(jfa, "BWD_IMPL", "stored_folddot")
    monkeypatch.setattr(tfa, "BWD_IMPL", "stored_folddot")
    want = _jax_grads(*inputs, 0.1)
    before = tfa.fused_attention_bwd_stored.launches
    got = _port_grads(*inputs, 0.1)
    assert tfa.fused_attention_bwd_stored.launches == before  # CPU: plain
    for name, a, b, c in zip("qkv", got, want, stored):
        np.testing.assert_array_equal(a, c, err_msg=f"d{name}")
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5,
                                   err_msg=f"d{name}")


def test_unknown_residual_dtype_raises(monkeypatch):
    q, k, v, bias, _ = (torch.from_numpy(a) for a in _inputs(2, 14, 14, 0))
    monkeypatch.setattr(tfa, "P_RESIDUAL_DTYPE", torch.float16)
    with pytest.raises(ValueError, match="residual dtype"):
        tfa.fused_attention_fwd_train(q, k, v, bias, HEADS, HEAD_SIZE, 0.0,
                                      0)
