"""Tiny VisualBERT: the port (crvqa_tpu_torch/models/visualbert.py, its mask
table and its stage-2 step) vs the JAX package, on the same params
(carried by `state_dict_from_jax`) and the same numpy inputs.

The single stream here is 14 text and 36 visual rows at 4 heads: 50 keys,
the row length VisualBERT gives the short attention kernels (over the 48
keys the backward kernel takes in one chunk), with JAX's fused attention
interpreted and off.

- fp32: logits and pooled vector within 1e-5 (the same math, summed in
  another order through 2 layers).
- bf16: logits within 0.05 * max|logit| + 0.02, the LXMERT tests' bound
  (bf16 rounds at other points in the two frameworks).
- Stage 2 (fp32, dropout 0): the tolerances of tests/test_torch_stage2.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.losses import dispatch_loss as jax_loss
from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import visualbert_mask_specs as jax_specs
from crvqa_tpu.masking.spec import \
    VISUALBERT_ALL_WEIGHT_TYPES as JAX_ALL_TYPES
from crvqa_tpu.models import layers as jl
from crvqa_tpu.models.visualbert import VisualBertConfig as JaxConfig
from crvqa_tpu.models.visualbert import VisualBertForVQA as JaxVisualBert
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu.train.common import model_inputs as jax_inputs
from crvqa_tpu_torch.core.convert import (carry_into_state, stage2_from_jax,
                                          state_dict_from_jax)
from crvqa_tpu_torch.masking import (VISUALBERT_ALL_WEIGHT_TYPES,
                                     visualbert_mask_specs)
from crvqa_tpu_torch.masking.masker import Masker, weight_name
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.models import VisualBertConfig, build_visualbert
from crvqa_tpu_torch.ops.fused_attention import fused_attention
from crvqa_tpu_torch.train import stage2
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

B, TEXT, BOXES = 3, 14, 36
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
LR = 1e-3


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, TEXT), np.float32)
    mask[1, 9:] = 0.0
    return dict(
        input_ids=rng.integers(1, cfg.vocab_size, (B, TEXT)).astype(np.int32),
        visual_embeds=rng.normal(size=(B, BOXES, cfg.visual_embedding_dim)
                                 ).astype(np.float32),
        attention_mask=mask)


def _jax_and_torch(dtype_name, fused, with_mask, monkeypatch, seed=0):
    monkeypatch.setattr(jl, "FUSED_ATTENTION", fused)
    monkeypatch.setattr(jl, "FUSED_ATTENTION_INTERPRET", True)
    jcfg = JaxConfig.tiny(dtype=getattr(jnp, dtype_name))
    jmodel = JaxVisualBert(jcfg)
    inputs = _inputs(jcfg, seed)
    if not with_mask:
        del inputs["attention_mask"]
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                  **jin)["params"]
    apply = jax.jit(jmodel.apply, static_argnames="deterministic")
    jlogits, jpooled = apply({"params": params}, deterministic=True, **jin)

    model = build_visualbert(VisualBertConfig.tiny(
        dtype=getattr(torch, dtype_name)))
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


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_tiny_visualbert_fp32_matches_jax(fused, with_mask, monkeypatch):
    jlogits, jpooled, logits, pooled = _jax_and_torch(
        "float32", fused, with_mask, monkeypatch)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pooled, jpooled, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_tiny_visualbert_bf16_matches_jax(fused, with_mask, monkeypatch):
    jlogits, _, logits, _ = _jax_and_torch("bfloat16", fused, with_mask,
                                           monkeypatch)
    assert np.all(np.isfinite(logits))
    bound = 0.05 * np.abs(jlogits).max() + 0.02
    assert np.abs(logits - jlogits).max() <= bound


def test_parameter_names_and_dtypes():
    """The reference's torch names; in bf16 the encoder's and the pooler's
    Linear weights are bf16, the embeddings, LayerNorms, the visual
    projection and the `cls` head stay fp32 (the JAX module's dtypes)."""
    model = build_visualbert(VisualBertConfig.tiny(dtype=torch.bfloat16))
    dtypes = stage2.param_dtypes(model)
    for name in ("visual_bert.embeddings.word_embeddings.weight",
                 "visual_bert.encoder.layer.0.attention.self.query.weight",
                 "visual_bert.pooler.dense.weight", "cls.main.0.weight_v"):
        assert name in dtypes, name
    for name, dt in dtypes.items():
        low = (".encoder." in name and "LayerNorm" not in name
               or name.startswith("visual_bert.pooler."))
        want = torch.bfloat16 if low else torch.float32
        assert dt == want, (name, dt)
    assert model.visual_bert.embeddings.word_embeddings.padding_idx == 0


@pytest.mark.parametrize("all_types", [False, True])
@pytest.mark.parametrize("layers", [2, 12])
def test_mask_specs_match_jax(layers, all_types):
    kw = dict(weight_types=VISUALBERT_ALL_WEIGHT_TYPES) if all_types else {}
    jkw = dict(weight_types=JAX_ALL_TYPES) if all_types else {}
    got = visualbert_mask_specs(layers, **kw)
    want = jax_specs(layers, **jkw)
    fields = lambda s: (s.key, s.torch_name, s.weight_type, s.modality,
                        s.is_embedding)
    assert [fields(s) for s in got] == [fields(s) for s in want]
    assert len(got) == 6 * layers + 2 + all_types
    if layers == 12 and not all_types:
        assert len(got) == 74
    names = build_visualbert(VisualBertConfig.tiny(num_hidden_layers=layers),
                             "meta").state_dict()
    assert all(weight_name(s) in names for s in got)


# ------------------------------------------------------------------ stage 2

def _batches(cfg, n, seed0=0):
    return [synthetic_batch(batch_size=4, seed=seed0 + i,
                            vocab_size=cfg.vocab_size, ans_num=cfg.ans_num,
                            feat_dim=cfg.visual_embedding_dim,
                            style="visualbert") for i in range(n)]


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()
           if k not in ("valid", "question_id")}
    out["input_ids"] = out["input_ids"].long()
    return out


@pytest.fixture(scope="module")
def both():
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    jmodel = JaxVisualBert(jcfg)
    b0 = _batches(jcfg, 1)[0]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(b0["input_ids"]),
        visual_embeds=jnp.asarray(b0["visual_embeds"]))["params"]
    jmasker = JaxMasker.create(jax_specs(jcfg.num_hidden_layers),
                               JaxSparsity.uniform(0.7),
                               controlled_init="magnitude")
    jsc = jstage2.Stage2Config(masker_type="lmh", learning_rate=LR,
                               total_steps=20, hidden_size=jcfg.hidden_size,
                               classifier_key="cls")
    jstate, tx = jstage2.init_state(jmodel, jmasker, params, jsc,
                                    jax.random.PRNGKey(1))
    carried = stage2_from_jax(
        jax.tree.map(np.asarray, jstate.frozen_params),
        jax.tree.map(np.asarray, jstate.train_params),
        jax.tree.map(np.asarray, jstate.scores),
        jax.tree.map(np.asarray, jstate.thresholds), jmasker.specs,
        classifier_key="cls")

    tcfg = VisualBertConfig.tiny(**NO_DROPOUT)
    masker = Masker.create(visualbert_mask_specs(tcfg.num_hidden_layers),
                           ModalSparsity.uniform(0.7),
                           controlled_init="magnitude")
    tsc = stage2.Stage2Config(masker_type="lmh", learning_rate=LR,
                              total_steps=20, hidden_size=tcfg.hidden_size,
                              classifier_key="cls")
    model = stage2.visualbert_meta_model(tcfg)

    def port_state():
        state, opt = stage2.init_state(model, masker, carried["params"], tsc,
                                       seed=0, device="cpu")
        carry_into_state(state, carried)
        return state, opt

    return dict(jcfg=jcfg, jmodel=jmodel, jmasker=jmasker, jsc=jsc,
                jstate=jstate, tx=tx, masker=masker, tsc=tsc, model=model,
                port_state=port_state)


def _close(got, want, what, atol=1e-6, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def test_stage2_state_carried_across(both):
    """The `cls` head leaves the frozen backbone for the trainables, and
    the port's own controlled init equals the carried scores."""
    state, _ = both["port_state"]()
    assert not any(k.startswith("cls.") for k in state.frozen)
    assert set(state.train_params["classifier"]) == {
        "main.0.weight_v", "main.0.weight_g", "main.0.bias",
        "main.3.weight_v", "main.3.weight_g", "main.3.bias"}
    own, _ = both["masker"].init(state.frozen)
    for k, v in own.items():
        torch.testing.assert_close(v, state.scores[k].detach(), rtol=0,
                                   atol=0)


def test_stage2_one_step_loss_and_gradients_match_jax(both):
    b = _batches(both["jcfg"], 1, seed0=10)[0]
    js, jm, jmasker = both["jstate"], both["jmodel"], both["jmasker"]
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "valid"}

    def loss_fn(trainable):
        params = jstage2.merge_params(js.frozen_params, trainable["train"],
                                      "cls")
        masked = jmasker.apply_masks(params, trainable["scores"],
                                     js.thresholds)
        logits, pooled = jm.apply({"params": masked}, **jax_inputs(jb),
                                  deterministic=True)
        return jax_loss("lmh", logits=logits, pooled=pooled,
                        labels=jb["labels"], bias=jb["bias"],
                        max_label=jb["max_label"],
                        lmh_params=trainable["train"]["lmh"])

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(
        {"train": js.train_params, "scores": js.scores})
    state, _ = both["port_state"]()
    fn = stage2.make_loss_and_grads(both["model"], both["masker"],
                                    both["tsc"])
    loss, _, grads = fn(state, _torch_batch(b))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for spec in both["masker"].specs:
        want = np.asarray(jg["scores"][spec.key])
        _close(grads[f"scores/{spec.key}"].numpy(),
               want if spec.is_embedding else want.T, spec.key)
    # the word table's pad row gets no gradient on either side
    e = next(s for s in both["masker"].specs if s.weight_type == "E")
    assert not grads[f"scores/{e.key}"][0].any()
    jclf = jg["train"]["classifier"]
    for layer in ("main_0", "main_3"):
        i = layer[-1]
        _close(grads[f"train/classifier/main.{i}.weight_v"].numpy(),
               np.asarray(jclf[layer]["v"]).T, f"{layer}/v")
        _close(grads[f"train/classifier/main.{i}.weight_g"].numpy(),
               np.asarray(jclf[layer]["g"]).reshape(()), f"{layer}/g")
        _close(grads[f"train/classifier/main.{i}.bias"].numpy(),
               np.asarray(jclf[layer]["bias"]), f"{layer}/bias")


def test_stage2_trajectory_matches_jax(both):
    """Two steps, a threshold reset, one more step and another reset:
    per-step losses, the updated classifier, scores, thresholds, masks and
    the zero rate against JAX."""
    batches = _batches(both["jcfg"], 3, seed0=20)
    jstep = jstage2.make_train_step(both["jmodel"], both["jmasker"],
                                    both["tx"], both["jsc"])
    jreset = jstage2.make_threshold_reset(both["jmasker"])
    js = jax.tree.map(jnp.array, both["jstate"])  # the step donates
    state, opt = both["port_state"]()
    step = stage2.make_train_step(both["model"], both["masker"], opt,
                                  both["tsc"])
    reset = stage2.make_threshold_reset(both["masker"])
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()
                            if k != "valid"})
        state, m = step(state, _torch_batch(b))
        jlosses.append(float(jm.loss))
        losses.append(float(m.loss))
        if i in (1, 2):  # mid-run, and before the final comparison
            js, state = jreset(js), reset(state)
    assert state.step == int(js.step) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    atol = 2 * LR * len(batches)
    clf = state_dict_from_jax(jax.tree.map(
        np.asarray, js.train_params["classifier"]))
    for name, want in clf.items():
        _close(state.train_params["classifier"][name].detach().numpy(),
               want.numpy(), name, atol=atol, rtol=0)
    agree = total = 0
    for spec in both["masker"].specs:
        want = np.asarray(js.scores[spec.key])
        want = want if spec.is_embedding else want.T
        got = state.scores[spec.key].detach().numpy()
        _close(got, want, spec.key, atol=atol, rtol=0)
        assert float(state.thresholds[spec.key]) == pytest.approx(
            float(js.thresholds[spec.key]), abs=atol)
        mask = got > float(state.thresholds[spec.key])
        jmask = want > float(js.thresholds[spec.key])
        agree += int((mask == jmask).sum())
        total += mask.size
    assert agree / total >= 0.995
    report = both["masker"].sparsity_report(state.scores, state.thresholds)
    assert abs(report["Uni"] - 0.7) < 0.02


def test_stage2_eval_step_reads_the_cls_head(both):
    """The eval step puts the trained head under `cls`: its logits equal
    the model's with the masked weights and the head loaded by name (to
    fp32 rounding: the two calls sum in another order)."""
    state, _ = both["port_state"]()
    b = _torch_batch(_batches(both["jcfg"], 1, seed0=30)[0])
    logits = stage2.make_eval_step(both["model"], both["masker"],
                                   both["tsc"])(state, b)
    model = build_visualbert(VisualBertConfig.tiny(**NO_DROPOUT))
    sd = both["masker"].apply_masks(state.frozen, state.scores,
                                    state.thresholds)
    sd.update({f"cls.{k}": v for k, v in
               state.train_params["classifier"].items()})
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        want, _ = model.eval()(b["input_ids"], b["visual_embeds"],
                               b["attention_mask"])
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-6)
