"""The port's mPLUG checkpoint import (`core.torch_compat.
load_mplug_torch_checkpoint`, `cli.common.load_params_any` and
`vqa_mplug --init_ckpt`) against the JAX package's on the CPU.

Reference-format checkpoints are fabricated from a tiny JAX `MPlug`'s
params (the port's names are the reference's): a `model`-wrapped dict, a
`module`-wrapped dict, a whole-module pickle whose class is not
importable, the pretraining format (`bert.` / `fusion.` inner prefixes, the
positional embedding at 64 px for a 32 px model), `_m` twins, and the
ViT-L `visn_fc` adapter; each also carries what the model has no
parameter for (the CLIP text tower, `visual.proj`, the tied decoder,
`position_ids`, a pooler). Both packages' loaders read each one: the
loaded tensors are byte-identical, and the `missing` / `unused` reports
name the same leaves. Then both CLIs start from a `.pth` and from a msgpack
params file the JAX package writes here, and the state each builds before
its first step (params; in mask mode the magnitude_soft scores and
thresholds) is compared byte for byte. Losses are not compared: the two
packages' dropout streams differ.
"""
import sys
import types

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from crvqa_tpu.cli import vqa_mplug as jcli
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.core import torch_compat as jtc
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.cli import common as tcommon
from crvqa_tpu_torch.cli import vqa_mplug as tcli
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.core import torch_compat as ttc
from crvqa_tpu_torch.train import mplug_train as ttrain
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

NOISE = {"visual_encoder.visual.proj": (32, 16),
         "visual_encoder.token_embedding.weight": (7, 16),
         "visual_encoder.logit_scale": (),
         "text_encoder.embeddings.position_ids": (1, 64),
         "text_encoder.pooler.dense.weight": (32, 32),
         "text_decoder.bert.pooler.dense.bias": (32,),
         "beam_generator.x": (3,)}


def _jax_params(vit_width=None, seed=1):
    argv = ["--tiny", "--dtype", "float32", "--output_dir", "unused"]
    config, _, model = jcli.build_model(jcli.build_parser().parse_args(argv))
    if vit_width:
        import dataclasses
        from crvqa_tpu.models.mplug import MPlug

        config = dataclasses.replace(config, vit=dataclasses.replace(
            config.vit, width=vit_width, heads=4))
        model = MPlug(config)
    from crvqa_tpu.data.mplug_data import synthetic_mplug_batch

    b = synthetic_mplug_batch(batch_size=2, image_res=32, vocab_size=128)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(seed), b["images"], b["question_ids"],
        b["question_mask"], b["answer_ids"], b["answer_mask"],
        b["weights"])["params"]
    return jax.tree.map(np.asarray, params)


def _reference_sd(params, rng):
    """The reference's finetuned-format state_dict of `params` (its names
    are the port's), plus what the model has no parameter for."""
    sd = {k: v.clone() for k, v in
          convert.mplug_state_dict_from_jax(params).items()}
    sd["text_decoder.cls.predictions.decoder.weight"] = sd[
        "text_decoder.bert.embeddings.word_embeddings.weight"].clone()
    for k, shape in NOISE.items():
        sd[k] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return sd


def _pretrain_sd(sd, rng):
    """The pretraining format: `bert.` / `fusion.` inner prefixes on the
    text and fusion towers, the positional embedding at 64 px (17 rows)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("text_encoder."):
            k = "text_encoder.bert." + k[len("text_encoder."):]
        elif k.startswith("fusion_encoder."):
            k = "fusion_encoder.fusion." + k[len("fusion_encoder."):]
        out[k] = v
    width = sd["visual_encoder.visual.positional_embedding"].shape[1]
    out["visual_encoder.visual.positional_embedding"] = torch.from_numpy(
        rng.normal(size=(17, width)).astype(np.float32))
    return out


class _Ghost(torch.nn.Module):
    """The root of a whole-module pickle, made unimportable after saving."""


def _save_module_pickle(sd, path):
    mod = types.ModuleType("ghost_mplug_for_pickle_test")
    _Ghost.__module__ = mod.__name__
    mod._Ghost = _Ghost
    sys.modules[mod.__name__] = mod
    root = _Ghost()
    for name, t in sd.items():
        *parts, leaf = name.split(".")
        m = root
        for part in parts:
            if part not in m._modules:
                m.add_module(part, torch.nn.Module())
            m = m._modules[part]
        m.register_parameter(leaf, torch.nn.Parameter(t.clone(),
                                                      requires_grad=False))
    torch.save(root, path)
    del sys.modules[mod.__name__]
    with pytest.raises((ModuleNotFoundError, AttributeError)):
        torch.load(path, map_location="cpu", weights_only=False)


def _generic_names(template):
    """{JAX package's torch-style name: the port's name} for every leaf of
    a flax template (the names its report uses)."""
    out = {}
    for path, arr in traverse_util.flatten_dict(template).items():
        parts = []
        for p in path[:-1]:
            stem, _, idx = p.rpartition("_")
            parts += [stem, idx] if stem and idx.isdigit() else [p]
        leaf = {"kernel": "weight", "embedding": "weight",
                "scale": "weight"}.get(path[-1], path[-1])
        out[".".join(parts + [leaf])] = convert.mplug_torch_name(
            path, np.asarray(arr))[0]
    return out


def _load_both(path, jparams, pretrain, twins=False):
    jtemplate = jax.tree.map(np.asarray, jparams)
    want, want_m, jrep = jtc.load_mplug_torch_checkpoint(
        path, jtemplate, template_m=jtemplate if twins else None,
        pretrain_format=pretrain)
    ttemplate = convert.mplug_state_dict_from_jax(jtemplate)
    got, got_m, trep = ttc.load_mplug_torch_checkpoint(
        path, ttemplate, template_m=dict(ttemplate) if twins else None,
        pretrain_format=pretrain)
    names = _generic_names(jtemplate)
    assert trep["missing"] == [names[n] for n in jrep["missing"]]
    assert sorted(trep["unused"]) == sorted(names.get(n, n)
                                            for n in jrep["unused"])
    for mine, theirs in ((got, want), (got_m, want_m)):
        if theirs is None:
            assert mine is None
            continue
        ref = convert.mplug_state_dict_from_jax(
            jax.tree.map(np.asarray, theirs))
        assert set(mine) == set(ref)
        for k in ref:
            assert mine[k].dtype == torch.float32
            assert torch.equal(mine[k], ref[k]), k
    if twins:
        assert trep["missing_m"] == [names[n] for n in jrep["missing_m"]]
    return got, got_m, trep


@pytest.fixture(scope="module")
def jparams():
    return _jax_params()


@pytest.mark.parametrize("wrap", ["model", "module", "pickle", "bare"])
def test_finetuned_formats_load_equal(tmp_path, jparams, wrap):
    """The finetuned format under every wrapping the reference reads
    (`model` first, then `module`, a whole-module pickle, a bare dict):
    every template leaf loaded, the noise reported unused."""
    rng = np.random.default_rng(0)
    sd = _reference_sd(jparams, rng)
    del sd["text_decoder.cls.predictions.bias"]  # one missing leaf
    path = str(tmp_path / "ckpt.pth")
    if wrap == "pickle":
        _save_module_pickle(sd, path)
    else:
        torch.save(sd if wrap == "bare" else {wrap: sd}, path)
    got, _, rep = _load_both(path, jparams, pretrain=False)
    assert rep["missing"] == ["text_decoder.cls.predictions.bias"]
    assert set(rep["unused"]) == set(NOISE) | {
        "text_decoder.cls.predictions.decoder.weight"}
    k = "fusion_encoder.encoder.layer.2.attention.self.query.weight"
    assert torch.equal(got[k], sd[k])


def test_pretrain_format_with_twins(tmp_path, jparams):
    """The pretraining format: the 64 px positional embedding (of the tower
    and of its `_m` twin) resized to the template's 5 rows, the `bert.` /
    `fusion.` shim, and `_m` twins routed to the twin state."""
    rng = np.random.default_rng(1)
    sd = _pretrain_sd(_reference_sd(jparams, rng), rng)
    for k in list(sd):
        tower = k.split(".", 1)[0]
        if tower in ("visual_encoder", "text_encoder", "fusion_encoder",
                     "text_decoder"):
            sd[tower + "_m" + k[len(tower):]] = sd[k] * 0.5
    path = str(tmp_path / "pretrain.pth")
    torch.save({"model": sd}, path)
    got, got_m, rep = _load_both(path, jparams, pretrain=True, twins=True)
    pos = "visual_encoder.visual.positional_embedding"
    assert got[pos].shape[0] == 5
    assert torch.equal(got[pos], ttc.resize_pos_embed_np(sd[pos], 5))
    assert torch.equal(got_m[pos], ttc.resize_pos_embed_np(
        sd["visual_encoder_m.visual.positional_embedding"], 5))
    q = "text_encoder.encoder.layer.0.attention.self.query.weight"
    assert torch.equal(got_m[q], got[q] * 0.5)
    assert rep["missing"] == [] and rep["missing_m"] == []


def test_resize_pos_embed_is_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(577, 24)).astype(np.float32)
    for new_len in (197, 577, 785):
        want = jtc.resize_pos_embed_np(pos, new_len)
        got = ttc.resize_pos_embed_np(torch.from_numpy(pos), new_len)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_strip_fusion_bert_keys_delete_quirk():
    """A key whose rename equals itself is DELETED (set, then del, of the
    same name), exactly as the JAX function and the reference do."""
    sd = {"text_encoder.bert.encoder.layer.0.w": 1,
          "fusion_encoder.fusion.encoder.layer.6.w": 2,
          "text_decoder.bert.encoder.layer.0.w": 3,
          "visual_encoder.visual.conv1.weight": 4,
          "fusion_encoder.encoder.layer.7.w": 5}
    got = ttc.strip_fusion_bert_keys(sd)
    assert got == jtc.strip_fusion_bert_keys(sd) == {
        "text_encoder.encoder.layer.0.w": 1,
        "fusion_encoder.encoder.layer.6.w": 2,
        "text_decoder.bert.encoder.layer.0.w": 3,
        "visual_encoder.visual.conv1.weight": 4}
    assert "fusion_encoder.encoder.layer.7.w" in sd  # the input is kept


def test_vit_l_adapter_loads_equal(tmp_path):
    """A ViT wider than the BERT stack: the `visn_fc` / `visn_layer_norm`
    adapter's keys load (model_vqa_mplug.py:143-147)."""
    jp = _jax_params(vit_width=64)
    assert "visn_fc" in jp and "visn_layer_norm" in jp
    sd = _reference_sd(jp, np.random.default_rng(3))
    path = str(tmp_path / "large.pth")
    torch.save({"model": sd}, path)
    got, _, rep = _load_both(path, jp, pretrain=False)
    assert torch.equal(got["visn_fc.weight"], sd["visn_fc.weight"])
    assert got["visn_fc.weight"].shape == (32, 64)
    assert rep["missing"] == []


def test_load_params_any_dispatch(tmp_path, jparams):
    """`.pth` through the torch hook, anything else a msgpack params file
    converted with the `from_jax` hook; the defaults unchanged."""
    template = convert.mplug_state_dict_from_jax(jparams)
    seen = []
    got = tcommon.load_params_any(
        str(tmp_path / "x.pth"), template,
        torch_loader=lambda p, t: seen.append(p) or t)
    assert got is template and seen == [str(tmp_path / "x.pth")]
    path = str(tmp_path / "params")
    jckpt.save_checkpoint(path, jparams)
    got = tcommon.load_params_any(
        path, {k: torch.zeros_like(v) for k, v in template.items()},
        from_jax=convert.mplug_state_dict_from_jax)
    for k in template:
        assert torch.equal(got[k], template[k]), k


# ------------------------------------------------------------------ CLIs

class _Built(Exception):
    pass


def _capture_jax(argv, monkeypatch):
    """The JAX CLI's state as `init_state` returns it, the run stopped
    there."""
    real = jtrain.init_state
    box = {}

    def spy(*a, **kw):
        state, tx = real(*a, **kw)
        box["state"] = jax.tree.map(np.asarray, state)
        raise _Built

    monkeypatch.setattr(jtrain, "init_state", spy)
    with pytest.raises(_Built):
        jcli.main(argv)
    monkeypatch.setattr(jtrain, "init_state", real)
    return box["state"]


def _capture_port(argv, monkeypatch):
    real = ttrain.init_state
    box = {}

    def spy(*a, **kw):
        state = real(*a, **kw)
        box["state"] = state
        raise _Built

    monkeypatch.setattr(ttrain, "init_state", spy)
    with pytest.raises(_Built):
        tcli.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(ttrain, "init_state", real)
    return box["state"]


@pytest.mark.parametrize("case", ["pth-pretrain-full", "pth-finetuned-mask",
                                  "msgpack-mask"])
def test_cli_init_ckpt_builds_the_jax_state(tmp_path, monkeypatch, jparams,
                                            case, caplog):
    """`vqa_mplug --init_ckpt` in both packages: a pretraining-format
    `.pth` in a full-mode training run (`auto` applies the shims), a
    finetuned `.pth` in mask mode (no shims; the scores are the loaded
    weights' magnitudes), and a msgpack params file the JAX package
    writes. The params, scores and thresholds each CLI builds before its
    first step are byte-identical."""
    rng = np.random.default_rng(4)
    sd = _reference_sd(jparams, rng)
    mode = "full" if case.endswith("full") else "mask"
    if case == "pth-pretrain-full":
        sd = _pretrain_sd(sd, rng)
    if case.startswith("pth"):
        path = str(tmp_path / "init.pth")
        torch.save({"model": sd}, path)
    else:
        path = str(tmp_path / "params_msgpack")
        jckpt.save_checkpoint(path, jparams)
    argv = ["--tiny", "--dtype", "float32", "--seed", "5", "--synthetic",
            "8", "--train_batch_size", "8", "--num_train_epochs", "1",
            "--mode", mode, "--init_ckpt", path, "--do_train"]
    jstate = _capture_jax(argv + ["--output_dir", str(tmp_path / "j")],
                          monkeypatch)
    with caplog.at_level("INFO", logger="crvqa_tpu_torch"):
        tstate = _capture_port(argv + ["--output_dir", str(tmp_path / "t")],
                               monkeypatch)
    want = convert.mplug_state_dict_from_jax(jstate.params)
    assert set(tstate.params) == set(want)
    for k, t in want.items():
        assert torch.equal(tstate.params[k].detach(), t), k
    if mode == "mask":
        args = tcli.build_parser().parse_args(argv + ["--output_dir", "x"])
        specs = tcli.build_masker(args, tcli.build_model(args)[0]).specs
        scores, thresholds = convert.mask_state_from_jax(
            jstate.scores, jstate.thresholds, specs)
        assert set(tstate.scores) == set(scores)
        for k in scores:
            assert torch.equal(tstate.scores[k].detach(), scores[k]), k
            assert torch.equal(tstate.thresholds[k], thresholds[k]), k
    if case.startswith("pth"):
        shims = " (pretrain-format shims applied)" if mode == "full" else ""
        assert any(r.getMessage().startswith(f"init_ckpt {path}: 0 template "
                                             "leaves missing,")
                   and r.getMessage().endswith("unused" + shims)
                   for r in caplog.records)
