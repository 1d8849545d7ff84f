"""The port's head / FFN compaction (crvqa_tpu_torch/masking/compaction.py)
vs the JAX package's, on one tiny LXMERT's weights carried across
(`core/convert.state_dict_from_jax`).

The compacted state_dicts equal the JAX compacted trees carried across, bit
for bit. A compacted port model (`lang_num_heads` / `lang_intermediate_size`,
strict load) gives the JAX compacted model's logits and the port's dense
masked model's within 1e-5 (fp32; the same products summed in another
order, and padded slots contribute exact zeros).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.masking import compaction as jcomp
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.masking import compaction as tcomp
from crvqa_tpu_torch.models import LxmertConfig, build_lxmert
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

HEAD_MASK = np.array([[1, 0, 1, 0], [0, 1, 0, 0]], np.float32)


@pytest.fixture(scope="module")
def setup():
    config = JaxConfig.tiny()
    model = JaxLxmert(config)
    batch = synthetic_batch(batch_size=4, vocab_size=config.vocab_size,
                            ans_num=config.ans_num,
                            feat_dim=config.visual_feat_dim,
                            pos_dim=config.visual_pos_dim)
    inputs = {k: jnp.asarray(batch[k]) for k in
              ("input_ids", "visual_feats", "visual_pos", "attention_mask")}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), **{
        k: v for k, v in inputs.items() if k != "attention_mask"})["params"]
    rng = np.random.default_rng(3)
    ffn_mask = (rng.random((config.l_layers, config.intermediate_size))
                < 0.5).astype(np.float32)
    ffn_mask[0, :5] = 1.0  # uneven kept counts
    return config, model, params, inputs, ffn_mask


def _port_logits(config, state, inputs):
    model = build_lxmert(config, "cpu")
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        return model.eval()(**{k: torch.from_numpy(np.array(v))
                               for k, v in inputs.items()})[0].numpy()


def _compact_both(params, head_mask, ffn_mask, head_size):
    """(JAX compacted tree carried across, port compacted state_dict,
    n_heads, n_inter) with the JAX package's pads (2 heads, 8 neurons)."""
    jp, tp = params, state_dict_from_jax(jax.tree.map(np.asarray, params))
    nh = ni = None
    if head_mask is not None:
        jp, nh = jcomp.compact_lang_heads(jp, head_mask, head_size)
        tp, nh2 = tcomp.compact_lang_heads(tp, head_mask, head_size)
        assert nh == nh2
    if ffn_mask is not None:
        jp, ni = jcomp.compact_lang_ffns(jp, ffn_mask, pad_to_multiple=8)
        tp, ni2 = tcomp.compact_lang_ffns(tp, ffn_mask, pad_to_multiple=8)
        assert ni == ni2
    return jp, tp, nh, ni


@pytest.mark.parametrize("which", ["heads", "ffns", "both"])
def test_compacted_weights_equal_the_jax_trees(setup, which):
    config, _, params, _, ffn_mask = setup
    jp, tp, nh, ni = _compact_both(
        params, HEAD_MASK if which != "ffns" else None,
        ffn_mask if which != "heads" else None, config.head_size)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp))
    assert set(tp) == set(want)
    for name, t in want.items():
        np.testing.assert_array_equal(tp[name].numpy(), t.numpy(),
                                      err_msg=name)
    if nh is not None:  # layer 1 keeps one head: its second slot is zero
        q1 = tp["lxmert.encoder.layer.1.attention.self.query.weight"]
        assert nh == 2 and q1.shape[0] == 2 * config.head_size
        assert not q1[config.head_size:].any()


def test_compacted_model_matches_jax_and_the_dense_mask(setup):
    config, model, params, inputs, ffn_mask = setup
    jp, tp, nh, ni = _compact_both(params, HEAD_MASK, ffn_mask,
                                   config.head_size)
    jcfg = dataclasses.replace(config, lang_num_heads=nh,
                               lang_intermediate_size=ni)
    apply = jax.jit(JaxLxmert(jcfg).apply, static_argnames="deterministic")
    want = np.asarray(apply({"params": jp}, **inputs, deterministic=True)[0])
    tcfg = LxmertConfig.tiny(lang_num_heads=nh, lang_intermediate_size=ni)
    got = _port_logits(tcfg, tp, inputs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    dense = state_dict_from_jax(jax.tree.map(np.asarray, params))
    dense = tcomp.apply_dense_ffn_mask(
        tcomp.apply_dense_head_mask(dense, HEAD_MASK, config.head_size),
        ffn_mask)
    ref = _port_logits(LxmertConfig.tiny(), dense, inputs)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the dense masks themselves equal the JAX package's
    jdense = jcomp.apply_dense_ffn_mask(jcomp.apply_dense_head_mask(
        params, HEAD_MASK, config.head_size), ffn_mask)
    for name, t in state_dict_from_jax(jax.tree.map(np.asarray,
                                                    jdense)).items():
        np.testing.assert_array_equal(dense[name].numpy(), t.numpy())


def test_head_mask_from_scores_matches():
    scores = np.random.default_rng(0).normal(size=(9, 12)).astype(np.float32)
    scores[0, :3] = scores[1, 0]  # ties break by position, stably
    for k in (0, 1, 40, 108):
        np.testing.assert_array_equal(tcomp.head_mask_from_scores(scores, k),
                                      jcomp.head_mask_from_scores(scores, k))
