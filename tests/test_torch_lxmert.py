"""Tiny LXMERT: the port (crvqa_tpu_torch/models/lxmert.py) vs the JAX
package, on the same params (carried by `state_dict_from_jax`) and the same
numpy inputs, with JAX's fused-attention kernel interpreted and off.

- fp32: logits and pooled output within rtol/atol 1e-4 (same math,
  summation order differs across 7 stacked layers).
- bf16: logits within 0.05 * max|logit| + 0.02. bf16 rounds at other
  points in the two frameworks (JAX's XLA attention rounds scores to bf16
  before the fp32 softmax, its gelu rounds every intermediate, torch's
  matmuls and gelu round once), and those differences compound over the
  layers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models import layers as jl
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from crvqa_tpu_torch.ops.fused_attention import fused_attention
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

B, BOXES = 3, 8


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(B, 14)).astype(np.int32)
    mask = np.ones((B, 14), np.float32)
    mask[1, 9:] = 0.0
    vmask = np.ones((B, BOXES), np.float32)
    vmask[2, 5:] = 0.0
    return dict(
        input_ids=ids,
        visual_feats=rng.normal(size=(B, BOXES, cfg.visual_feat_dim)).astype(
            np.float32),
        visual_pos=rng.random((B, BOXES, cfg.visual_pos_dim)).astype(
            np.float32),
        attention_mask=mask, visual_attention_mask=vmask)


def _jax_and_torch(dtype_name, fused, monkeypatch, seed=0):
    monkeypatch.setattr(jl, "FUSED_ATTENTION", fused)
    monkeypatch.setattr(jl, "FUSED_ATTENTION_INTERPRET", True)
    jcfg = JaxConfig.tiny(dtype=getattr(jnp, dtype_name))
    jmodel = JaxLxmert(jcfg)
    inputs = _inputs(jcfg, seed)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                  **jin)["params"]
    apply = jax.jit(jmodel.apply, static_argnames="deterministic")
    jlogits, jpooled = apply({"params": params}, deterministic=True, **jin)

    model = build_lxmert(LxmertConfig.tiny(dtype=getattr(torch, dtype_name)))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                           params)),
                          strict=True)
    model.eval()
    before = fused_attention.launches
    with torch.inference_mode():
        tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
        tin["input_ids"] = tin["input_ids"].long()
        logits, pooled = model(**tin)
    assert fused_attention.launches == before  # CPU tensors: plain version
    assert logits.dtype == torch.float32 and pooled.dtype == torch.float32
    return (np.asarray(jlogits), np.asarray(jpooled), logits.numpy(),
            pooled.numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_lxmert_fp32_matches_jax(fused, monkeypatch):
    jlogits, jpooled, logits, pooled = _jax_and_torch("float32", fused,
                                                      monkeypatch)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pooled, jpooled, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_lxmert_bf16_matches_jax(fused, monkeypatch):
    jlogits, _, logits, _ = _jax_and_torch("bfloat16", fused, monkeypatch)
    assert np.all(np.isfinite(logits))
    bound = 0.05 * np.abs(jlogits).max() + 0.02
    assert np.abs(logits - jlogits).max() <= bound


def test_cross_attention_weights_shared():
    """One `visual_attention` per cross layer serves both directions: no
    separate parameters for the vision -> language direction."""
    model = build_lxmert(LxmertConfig.tiny())
    names = [n for n in model.state_dict() if ".x_layers.0." in n]
    assert any(".visual_attention.att.query." in n for n in names)
    assert not any("visn_attention" in n or "lang_attention" in n
                   for n in names)
