"""The port's mPLUG model (crvqa_tpu_torch/models/mplug) vs the JAX
package's on the CPU: the ViT past the mid-length bound, the text encoder,
the fusion encoder (stride and non-stride layers) and the decoder (full,
`position`, cached steps, `memory_groups`, `cross_kv`), each on weights
carried across by `mplug_state_dict_from_jax`, in fp32. And the launch
path: the port sends the same attentions to the mid-length kernel, the
short kernel and the eager path as the JAX package does.

Tolerance: atol 2e-5 on activations and logits (fp32 on both sides; the
two differ in summation order and in the softmax's exp).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.models import layers as jlayers
from crvqa_tpu.models.mplug import MPlug as JMPlug
from crvqa_tpu.models.mplug import MPlugConfig as JConfig
from crvqa_tpu.models.mplug.bert import MPlugBertConfig as JBertConfig
from crvqa_tpu.models.mplug.generator import \
    init_self_caches as jinit_caches
from crvqa_tpu.models.mplug.generator import \
    precompute_cross_kv as jcross_kv
from crvqa_tpu.models.mplug.vit import ViTConfig as JViTConfig
from crvqa_tpu.models.mplug.vit import VisionTransformer as JViT
from crvqa_tpu.ops import fused_attention as jfa
from crvqa_tpu.ops import midseq_attention as jma
from crvqa_tpu_torch.core.convert import mplug_state_dict_from_jax
from crvqa_tpu_torch.models import layers as tlayers
from crvqa_tpu_torch.models.mplug import (MPlugBertConfig, MPlugConfig,
                                          ViTConfig, build_mplug)
from crvqa_tpu_torch.models.mplug.generator import (init_self_caches,
                                                    precompute_cross_kv)
from crvqa_tpu_torch.models.mplug.vit import VisionTransformer
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

ATOL = 2e-5

# (bert overrides, ViT config) of MPlugConfig.tiny(). "mid" is past the
# mid-length bound: 325 image tokens x 4 heads = 1300 > 1024, so the ViT
# self-attention, the fusion cross-attention, the stride layer's joint
# attention and the decoder's cross-attention over the 331-token memory
# all take the mid-length tier; fusion_layers 3 at stride 2 makes the last
# fusion layer a stride layer. "adapter": a ViT wider than the BERT stack
# (ViT-L-14's case) adds the visn_fc / visn_layer_norm adapter.
CONFIGS = {
    "tiny": ({}, None),
    "mid": (dict(fusion_layers=3), dict(image_res=288, patch_size=16,
                                        width=32, layers=1, heads=4)),
    "adapter": ({}, dict(image_res=32, patch_size=16, width=48, layers=1,
                         heads=4)),
}


def _configs(name: str):
    bert, vit = CONFIGS[name]
    jc = JConfig(bert=JBertConfig.tiny(**bert),
                 vit=JViTConfig(**vit) if vit else JViTConfig.tiny())
    tc = MPlugConfig(bert=MPlugBertConfig.tiny(**bert),
                     vit=ViTConfig(**vit) if vit else ViTConfig.tiny())
    return jc, tc


def _batch(jc, b=2, q_len=6, seed=0):
    rng = np.random.default_rng(seed)
    res = jc.vit.image_res
    images = rng.integers(0, 256, (b, res, res, 3)).astype(np.uint8)
    ids = rng.integers(1, jc.bert.vocab_size, (b, q_len)).astype(np.int32)
    mask = np.ones((b, q_len), np.float32)
    mask[1, q_len - 2:] = 0.0  # a padded question
    ids[1, q_len - 2:] = 0
    return images, ids, mask


def _models(name: str, seed=0):
    jc, tc = _configs(name)
    jm = JMPlug(jc)
    images, ids, mask = _batch(jc)
    a_ids = np.ones((2, 1, 3), np.int32)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(a_ids), jnp.ones((2, 1, 3)),
        jnp.ones((2, 1)))["params"]
    tm = build_mplug(tc)
    tm.load_state_dict(mplug_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny")


@pytest.fixture(scope="module")
def mid():
    return _models("mid")


@pytest.fixture(scope="module")
def adapter():
    return _models("adapter")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_vit_mid_length_matches_jax_kernel(monkeypatch):
    """192 px, width 256, 8 heads: 145 tokens x 8 heads = 1160 > 1024, so
    both sides dispatch the self-attention to the mid-length kernel (the
    JAX one interpreted)."""
    c = dict(image_res=192, patch_size=16, width=256, layers=2, heads=8)
    jm = JViT(JViTConfig(**c))
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, 192, 192, 3)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(imgs))["params"]
    monkeypatch.setattr(jlayers, "MIDSEQ_ATTENTION", True)
    monkeypatch.setattr(jlayers, "FUSED_ATTENTION_INTERPRET", True)
    want = jm.apply({"params": params}, jnp.asarray(imgs))

    sd = mplug_state_dict_from_jax({"visual_encoder": jax.tree.map(
        np.asarray, params)})
    sd = {k.removeprefix("visual_encoder.visual."): v for k, v in sd.items()}
    tm = VisionTransformer(ViTConfig(**c))
    tm.load_state_dict(sd, strict=True)
    calls = []
    real = tlayers.midseq_attention
    monkeypatch.setattr(tlayers, "midseq_attention",
                        lambda q, k, *a, **kw: calls.append(1)
                        or real(q, k, *a, **kw))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(imgs))
    assert len(calls) == 2
    _close(got, want)


def _encode_both(jm, params, tm, images, ids, mask):
    want = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(ids),
                    jnp.asarray(mask), method=jm.encode)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(images), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    return got, want


@pytest.mark.parametrize("which", ["tiny", "mid", "adapter"])
def test_towers_match_jax(which, request):
    """ViT, text encoder and fusion encoder one by one, then `encode`."""
    jm, params, tm = request.getfixturevalue(which)
    images, ids, mask = _batch(jm.config)
    ap = lambda fn, *a: jm.apply({"params": params}, *a, method=fn)
    adapt = which == "adapter"
    with torch.inference_mode():
        img_t = tm.visual_encoder(torch.from_numpy(images))
        mem_t = tm.visn_layer_norm(tm.visn_fc(img_t)) if adapt else img_t
        txt_t = tm.text_encoder(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
        fused_t = tm.fusion_encoder(txt_t, torch.from_numpy(mask), mem_t,
                                    torch.ones(img_t.shape[:2]))
    img_j = ap(lambda m, x: m.visual_encoder(x), jnp.asarray(images))
    mem_j = (ap(lambda m, x: m.visn_layer_norm(m.visn_fc(x)), img_j)
             if adapt else img_j)
    txt_j = ap(lambda m, i, k: m.text_encoder(i, k), jnp.asarray(ids),
               jnp.asarray(mask))
    fused_j = ap(lambda m, t, k, i: m.fusion_encoder(
        t, k, i, jnp.ones(i.shape[:2])), txt_j, jnp.asarray(mask), mem_j)
    _close(img_t, img_j)
    _close(mem_t, mem_j)
    _close(txt_t, txt_j)
    for a, b in zip(fused_t, fused_j):
        _close(a, b)
    got, want = _encode_both(jm, params, tm, images, ids, mask)
    for a, b in zip(got, want):
        _close(a, b)


def _memory(jm, params, tm, b=2):
    images, ids, mask = _batch(jm.config, b=b)
    (st, sm), (jst, jsm) = _encode_both(jm, params, tm, images, ids, mask)
    return st, sm, jst, jsm


@pytest.mark.parametrize("which", ["tiny", "mid"])
def test_decoder_full_position_groups_and_cross_kv(which, request):
    jm, params, tm = request.getfixturevalue(which)
    st, sm, jst, jsm = _memory(jm, params, tm)
    c = jm.config.bert
    g, length = 3, 5
    rng = np.random.default_rng(1)
    ids = rng.integers(1, c.vocab_size, (2 * g, length)).astype(np.int32)
    amask = np.ones((2 * g, length), np.float32)
    amask[1, 3:] = 0.0
    dec = lambda **kw: jm.apply({"params": params}, jnp.asarray(ids),
                                jnp.asarray(amask), jst, jsm,
                                method=jm.decode_logits, **kw)
    jkv = jcross_kv(params["text_decoder"], jst, c.text_decode_layers,
                    c.num_attention_heads, c.head_size)
    with torch.inference_mode():
        tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(amask)
        tkv = precompute_cross_kv(tm.text_decoder, st, c.text_decode_layers,
                                  c.num_attention_heads, c.head_size)
        for (k, v), (jk, jv) in zip(tkv, jkv):
            _close(k, jk)
            _close(v, jv)
        rep = lambda t: t.repeat_interleave(g, dim=0)
        cases = [
            (tm.decode_logits(tids, tmask, rep(st), rep(sm)),
             jm.apply({"params": params}, jnp.asarray(ids),
                      jnp.asarray(amask), jnp.repeat(jst, g, 0),
                      jnp.repeat(jsm, g, 0), method=jm.decode_logits)),
            (tm.decode_logits(tids, tmask, st, sm, memory_groups=g),
             dec(memory_groups=g)),
            (tm.decode_logits(tids, tmask, st, sm, memory_groups=g,
                              position=2),
             dec(memory_groups=g, position=2)),
            (tm.decode_logits(tids, tmask, st, sm, memory_groups=g,
                              cross_kv=tkv, position=4),
             dec(memory_groups=g, cross_kv=jkv, position=4)),
        ]
    for got, want in cases:
        assert got.shape == want.shape
        _close(got, want)


@pytest.mark.parametrize("which", ["tiny", "mid"])
def test_cached_decode_steps_match_jax(which, request):
    """Incremental decoding over grouped memory with cached cross K/V:
    each step's logits and the self-attention caches after the last step,
    and the cached logits equal the uncached full decode's."""
    jm, params, tm = request.getfixturevalue(which)
    st, sm, jst, jsm = _memory(jm, params, tm)
    c = jm.config.bert
    w, max_len = 2, 5
    n = 2 * w
    ids = np.random.default_rng(2).integers(1, c.vocab_size,
                                            (n, max_len)).astype(np.int32)
    jkv = jcross_kv(params["text_decoder"], jst, c.text_decode_layers,
                    c.num_attention_heads, c.head_size)
    jcaches = jinit_caches(n, c.text_decode_layers, max_len,
                           c.num_attention_heads, c.head_size)
    with torch.inference_mode():
        tids = torch.from_numpy(ids).long()
        tkv = precompute_cross_kv(tm.text_decoder, st, c.text_decode_layers,
                                  c.num_attention_heads, c.head_size)
        caches = init_self_caches(n, c.text_decode_layers, max_len,
                                  c.num_attention_heads, c.head_size)
        full = tm.decode_logits(tids, torch.ones(n, max_len), st, sm,
                                cross_kv=tkv, memory_groups=w)
        for pos in range(max_len):
            got, caches = tm.decode_logits_step(tids, st, sm, pos, caches,
                                                cross_kv=tkv,
                                                memory_groups=w)
            want, jcaches = jm.apply(
                {"params": params}, jnp.asarray(ids), jst, jsm, pos, jcaches,
                cross_kv=jkv, memory_groups=w, method=jm.decode_logits_step)
            _close(got, want)
            _close(got[:, 0], full[:, pos])
    for (k, v), (jk, jv) in zip(caches, jcaches):
        _close(k, jk)
        _close(v, jv)


def _spy_jax(monkeypatch, calls):
    for mod, name, tag in ((jma, "midseq_attention_seeded", "midseq"),
                           (jfa, "fused_attention_seeded", "fused")):
        real = getattr(mod, name)

        def spy(q, k, *a, _real=real, _tag=tag, **kw):
            calls.append((_tag, q.shape[1], k.shape[1]))
            return _real(q, k, *a, **kw)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(jlayers, "MIDSEQ_ATTENTION", True)
    monkeypatch.setattr(jlayers, "FUSED_ATTENTION", True)
    monkeypatch.setattr(jlayers, "FUSED_ATTENTION_INTERPRET", True)


def _spy_torch(monkeypatch, calls):
    for name, tag in (("midseq_attention", "midseq"),
                      ("fused_attention", "fused")):
        real = getattr(tlayers, name)

        def spy(q, k, *a, _real=real, _tag=tag, **kw):
            calls.append((_tag, q.shape[1], k.shape[1]))
            return _real(q, k, *a, **kw)

        monkeypatch.setattr(tlayers, name, spy)


def test_launch_path_matches_jax_dispatch(mid, monkeypatch):
    """Encode + the shortlist ranker (bos-only pass, shortlist pass) and a
    cached decode step at a mid-length config: the same attentions, in the
    same order, take the mid-length kernel and the short kernel on both
    sides; the rest (causal self-attention, the cached K/V paths) stays
    eager on both. The results agree too."""
    jm, params, tm = mid
    images, ids, mask = _batch(jm.config)
    c = jm.config.bert
    k_test = 2
    alist = np.random.default_rng(3).integers(1, c.vocab_size, (5, 4)).astype(
        np.int32)
    alist[:, 0] = jm.config.bos_token_id
    amask = np.ones((5, 4), np.float32)
    amask[2, 3] = 0.0
    jcalls, tcalls = [], []
    _spy_jax(monkeypatch, jcalls)
    _spy_torch(monkeypatch, tcalls)
    jout = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(ids),
                    jnp.asarray(mask), jnp.asarray(alist), jnp.asarray(amask),
                    k=k_test, method=jm.rank_answers_topk)
    with torch.inference_mode():
        tout = tm.rank_answers_topk(
            torch.from_numpy(images), torch.from_numpy(ids).long(),
            torch.from_numpy(mask), torch.from_numpy(alist).long(),
            torch.from_numpy(amask), k=k_test)
    p, f = 325, jm.config.vit.image_res // 16
    assert f * f + 1 == p
    want = ([("midseq", p, p)]                          # ViT
            + [("fused", 6, 6)] * 2                     # text encoder
            + [("fused", 6, 6), ("midseq", 6, p)] * 2   # fusion, non-stride
            + [("midseq", p + 6, p + 6)]                # fusion, stride
            + [("fused", 1, 1), ("midseq", 1, p + 6)] * 2   # bos-only pass
            + [("midseq", k_test * 4, p + 6)] * 2)      # shortlist pass
    assert jcalls == want
    assert tcalls == want
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    _close(tout[1], jout[1], atol=1e-5)

    # beam decoding's cached step: no kernel on either side
    jcalls.clear()
    tcalls.clear()
    st, sm, jst, jsm = _memory(jm, params, tm)
    jcalls.clear()
    tcalls.clear()
    jkv = jcross_kv(params["text_decoder"], jst, c.text_decode_layers,
                    c.num_attention_heads, c.head_size)
    jm.apply({"params": params}, jnp.ones((4, 3), jnp.int32), jst, jsm, 0,
             jinit_caches(4, c.text_decode_layers, 3, c.num_attention_heads,
                          c.head_size),
             cross_kv=jkv, memory_groups=2, method=jm.decode_logits_step)
    with torch.inference_mode():
        tkv = precompute_cross_kv(tm.text_decoder, st, c.text_decode_layers,
                                  c.num_attention_heads, c.head_size)
        tm.decode_logits_step(torch.ones(4, 3, dtype=torch.long), st, sm, 0,
                              init_self_caches(4, c.text_decode_layers, 3,
                                               c.num_attention_heads,
                                               c.head_size),
                              cross_kv=tkv, memory_groups=2)
    assert jcalls == [] and tcalls == []


def test_bf16_encode_close_to_fp32(tiny):
    """The bf16 dtype policy (LayerNorm statistics, scores and softmax in
    fp32, Linear weights in bf16) on the carried weights: the fused memory
    stays within bf16 rounding of the fp32 one (atol 0.1 on values of
    order 1 after 2+2+2 layers)."""
    jm, params, tm = tiny
    bf = build_mplug(dataclasses.replace(
        tm.config, bert=dataclasses.replace(tm.config.bert,
                                            dtype=torch.bfloat16),
        vit=dataclasses.replace(tm.config.vit, dtype=torch.bfloat16)))
    bf.load_state_dict(tm.state_dict(), strict=True)
    images, ids, mask = _batch(jm.config)
    args = (torch.from_numpy(images), torch.from_numpy(ids).long(),
            torch.from_numpy(mask))
    with torch.inference_mode():
        want, _ = tm.encode(*args)
        got, _ = bf.eval().encode(*args)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, atol=0.1)
