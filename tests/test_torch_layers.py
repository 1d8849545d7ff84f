"""The port's building blocks (crvqa_tpu_torch/models/layers.py) vs the JAX
package's (crvqa_tpu/models/layers.py), with the JAX params carried across
by `crvqa_tpu_torch.core.convert.state_dict_from_jax`.

fp32, atol 1e-5 unless stated: the same math in two frameworks, differing
only in summation order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.core import torch_compat
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models import layers as jl
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.models import layers as tl
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

H, D, HID, FFN = 4, 8, 32, 64


def _np_params(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.random.default_rng(0).normal(scale=3.0, size=(4096,)).astype(
        np.float32)
    ours = tl.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    theirs = jl.gelu(jnp.asarray(x).astype(getattr(jnp, dtype)))
    ours = ours.float().numpy()
    theirs = np.asarray(theirs.astype(jnp.float32))
    if dtype == "float32":  # exact erf form on both sides
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    else:
        # tanh form on both sides. torch evaluates it in fp32 and rounds
        # once: within half a bf16 ulp (2^-9 relative) of the exact tanh
        # form of the bf16 input. JAX rounds every intermediate to bf16,
        # which puts it up to ~3e-3 away where the output is small.
        xb = torch.from_numpy(x).to(torch.bfloat16).float()
        exact = torch.nn.functional.gelu(xb, approximate="tanh").numpy()
        np.testing.assert_allclose(ours, exact, rtol=2 ** -8, atol=1e-6)
        np.testing.assert_allclose(ours, theirs, rtol=8e-3, atol=4e-3)


def test_weight_norm_dense_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    mod = jl.WeightNormDense(40)
    params = jax.jit(mod.init)(jax.random.PRNGKey(0),
                               jnp.asarray(x))["params"]
    ours = tl.WeightNormDense(24, 40)
    ours.load_state_dict(state_dict_from_jax(_np_params(params)), strict=True)
    assert ours.weight_g.shape == ()
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    got = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extend_attention_mask_matches_jax():
    mask = np.asarray([[1, 1, 0, 0], [1, 0, 1, 0]], np.float32)
    got = tl.extend_attention_mask(torch.from_numpy(mask)).numpy()
    want = np.asarray(jl.extend_attention_mask(jnp.asarray(mask)))
    assert got.shape == (2, 1, 1, 4)
    np.testing.assert_array_equal(got, want)
    assert tl.extend_attention_mask(None) is None


@pytest.mark.parametrize("seq,fused", [(14, False), (14, True), (36, True),
                                       (300, True)])
def test_transformer_layer_matches_jax(seq, fused, monkeypatch):
    """seq 14/36 go through the port's fused_attention wrapper (plain on
    the CPU); seq 300 (4 heads x 300 > 1024) takes the eager path on both
    sides. JAX's fused kernel runs interpreted when `fused`."""
    monkeypatch.setattr(jl, "FUSED_ATTENTION", fused)
    monkeypatch.setattr(jl, "FUSED_ATTENTION_INTERPRET", True)
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(3, seq, HID)).astype(np.float32)
    mask = np.ones((3, seq), np.float32)
    mask[1, seq // 2:] = 0.0
    jmod = jl.TransformerLayer(H, D, HID, FFN, attn_dropout=0.0,
                               hidden_dropout=0.0)
    jbias = jl.extend_attention_mask(jnp.asarray(mask))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seq), jnp.asarray(x),
                                jbias)["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jbias))

    ours = tl.TransformerLayer(H, D, HID, FFN).eval()
    ours.load_state_dict(state_dict_from_jax(_np_params(params)), strict=True)
    with torch.inference_mode():
        got = ours(torch.from_numpy(x),
                   tl.extend_attention_mask(torch.from_numpy(mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_state_dict_from_jax_matches_flax_naming():
    """The flax-free conversion gives exactly the JAX package's own
    `flax_to_torch_state_dict` on a whole tiny LXMERT."""
    cfg = JaxConfig.tiny()
    b = 2
    params = jax.jit(JaxLxmert(cfg).init)(
        jax.random.PRNGKey(0), input_ids=jnp.ones((b, 14), jnp.int32),
        visual_feats=jnp.zeros((b, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((b, 8, cfg.visual_pos_dim)))["params"]
    ours = state_dict_from_jax(_np_params(params))
    theirs = torch_compat.flax_to_torch_state_dict(params)
    assert set(ours) == set(theirs)
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
