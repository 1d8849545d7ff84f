"""Structured mask training in the port (crvqa_tpu_torch/masking/
structured.py and `prune_debias_vqa --structured_masking`) against the JAX
package's (`crvqa_tpu.masking.structured`), on seeded numpy inputs and
the tiny LXMERT (4 heads of 8, fp32, every dropout 0).

Tolerances, fp32: masks, thresholds, masked weights and head masks exact;
magnitude head scores and sparsity reports rtol 1e-6; loss rtol 1e-5;
gradients atol 1e-6 + rtol 1e-4 (tests/test_torch_stage2.py states why).
The port's weights are `[out, in]`: a head owns a block of rows where the
JAX kernel `[in, out]` gives it a block of columns.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.losses import dispatch_loss as jax_loss
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import compaction as jcomp
from crvqa_tpu.masking import lxmert_mask_specs as jax_specs
from crvqa_tpu.masking import structured as jst
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu.train.common import model_inputs as jax_inputs
from crvqa_tpu_torch.cli import (prune_debias_vqa, prune_debias_vqavs,
                                 run_vqa_stage1, run_vqa_stage3)
from crvqa_tpu_torch.core.convert import (carry_into_state,
                                          state_dict_from_jax,
                                          stage2_from_jax)
from crvqa_tpu_torch.masking import compaction as tcomp
from crvqa_tpu_torch.masking import structured as tst
from crvqa_tpu_torch.masking.masker import weight_name
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.train import stage2
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
SP = (0.3, 0.3, 0.3, 0.7)
LR = 1e-3


def _close(got, want, what, atol=1e-6, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _maskers(kind, types=("self",), **kw):
    cfg = JaxConfig.tiny()
    jm = jst.StructuredMasker.create(
        jax_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers),
        JaxSparsity.from_compression(*SP), controlled_init="magnitude",
        structured_masking=kind, structured_types=types,
        num_heads=cfg.num_attention_heads, **kw)
    tm = tst.StructuredMasker.create(
        lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers),
        ModalSparsity.from_compression(*SP), controlled_init="magnitude",
        structured_masking=kind, structured_types=types,
        num_heads=cfg.num_attention_heads, **kw)
    return jm, tm


def _batch(cfg, seed):
    return synthetic_batch(batch_size=4, seed=seed,
                           vocab_size=cfg.vocab_size, ans_num=cfg.ans_num,
                           feat_dim=cfg.visual_feat_dim,
                           pos_dim=cfg.visual_pos_dim)


@pytest.fixture(scope="module", params=["heads", "layers"])
def both(request):
    """One JAX structured stage-2 state (tiny, no dropout) and the port's
    state carried across from it (`stage2_from_jax`)."""
    kind = request.param
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    jmodel = JaxLxmert(jcfg)
    b0 = _batch(jcfg, 0)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(b0["input_ids"]),
        visual_feats=jnp.asarray(b0["visual_feats"]),
        visual_pos=jnp.asarray(b0["visual_pos"]))["params"]
    jmasker, masker = _maskers(kind)
    jsc = jstage2.Stage2Config(masker_type="lmh", learning_rate=LR,
                               total_steps=20, hidden_size=jcfg.hidden_size)
    jstate, jtx = jstage2.init_state(jmodel, jmasker, params, jsc,
                                     jax.random.PRNGKey(1))
    # a reset first, so that about 70% of each head spec's gates are off
    jstate = jstage2.make_threshold_reset(jmasker)(jstate)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    carried = stage2_from_jax(np_(jstate.frozen_params),
                              np_(jstate.train_params), np_(jstate.scores),
                              np_(jstate.thresholds), jmasker.specs)
    tcfg = LxmertConfig.tiny(**NO_DROPOUT)
    tsc = stage2.Stage2Config(masker_type="lmh", learning_rate=LR,
                              total_steps=20, hidden_size=tcfg.hidden_size)
    model = stage2.lxmert_meta_model(tcfg)

    def port_state():
        state, tx = stage2.init_state(model, masker, carried["params"], tsc,
                                      seed=0, device="cpu")
        carry_into_state(state, carried)
        return state, tx

    state, _ = port_state()
    return dict(kind=kind, jcfg=jcfg, jmodel=jmodel, jmasker=jmasker,
                jstate=jstate, jsc=jsc, jtx=jtx, params=params,
                carried=carried, masker=masker, tsc=tsc, model=model,
                state=state, port_state=port_state)


def _t(spec, arr):
    """A JAX leaf in the port's layout (kernels transposed)."""
    arr = np.asarray(arr)
    return arr.T if arr.ndim == 2 and not spec.is_embedding else arr


# ------------------------------------------------------------ binarizers

@pytest.mark.parametrize("k", ["0", "1", "some", "all"])
def test_binarize_head_ste_matches_jax(k):
    rng = np.random.default_rng(4)
    scores = (rng.integers(0, 5, (3, 12)) / 4).astype(np.float32)  # ties
    k = {"0": 0, "1": 1, "some": 13, "all": scores.size}[k]
    want = np.asarray(jst.binarize_head_ste(jnp.asarray(scores), k))
    s = torch.from_numpy(scores).requires_grad_()
    got = tst.binarize_head_ste(s, k)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert int((got == 0).sum()) == k
    c = torch.from_numpy(rng.normal(size=scores.shape).astype(np.float32))
    (g,) = torch.autograd.grad((got * c).sum(), s)
    jg = jax.grad(lambda x: jnp.sum(jst.binarize_head_ste(x, k)
                                    * jnp.asarray(c.numpy())))(
        jnp.asarray(scores))
    np.testing.assert_array_equal(g.numpy(), c.numpy())
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_binarize_ffn_ste_is_the_threshold_ste():
    s = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    out = tst.binarize_ffn_ste(s, torch.tensor(0.2))
    np.testing.assert_array_equal(out.detach().numpy(), [0, 0, 1])
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jst.binarize_ffn_ste(jnp.asarray([0.1, 0.2, 0.3]),
                                        jnp.asarray(0.2))))


@pytest.mark.parametrize("heads", [4, 12])
def test_expand_head_mask_is_jax_transposed(heads):
    rng = np.random.default_rng(heads)
    mask = (rng.random(heads) < 0.5).astype(np.float32)
    out_dim, in_dim = heads * 8, 24
    want = np.asarray(jst.expand_head_mask_to_kernel(jnp.asarray(mask),
                                                     (in_dim, out_dim)))
    got = tst.expand_head_mask_to_kernel(torch.from_numpy(mask),
                                         (out_dim, in_dim))
    assert tuple(got.shape) == (out_dim, in_dim)
    np.testing.assert_array_equal(got.numpy(), want.T)


def test_magnitude_head_scores_match_jax():
    cfg = JaxConfig.tiny()
    jm, tm = _maskers("heads")
    specs = [s for s in jm.specs if jm._is_structured(s)]
    rng = np.random.default_rng(5)
    jparams, tparams = {}, {}
    for s in specs:
        w = rng.normal(size=(cfg.hidden_size, cfg.hidden_size)
                       ).astype(np.float32)
        node = jparams
        for p in s.path[:-1]:
            node = node.setdefault(p, {})
        node[s.path[-1]] = jnp.asarray(w)
        tparams[weight_name(s)] = torch.from_numpy(w.T.copy())
    want = jst.magnitude_head_scores(jparams, specs, cfg.num_attention_heads)
    got = tst.magnitude_head_scores(tparams, specs, cfg.num_attention_heads)
    for s in specs:
        _close(got[s.key].numpy(), np.asarray(want[s.key]), s.key,
               atol=0, rtol=1e-6)


@pytest.mark.parametrize("types", [
    "self", ".self.,.att.", "query", "attention", "lang_self_att,visn_fc",
    "", "x_layers"])
def test_structured_spec_set_matches_jax(types):
    t = tuple(x for x in types.split(",") if x)
    jm, tm = _maskers("heads", t)
    want = {s.key for s in jm.specs if jm._is_structured(s)}
    got = {s.key for s in tm.specs if tm._is_structured(s)}
    assert got == want
    assert bool(got) == bool(t)


@pytest.mark.parametrize("kind", ["heads", "layers"])
def test_mask_biases_raises_on_both_sides(kind):
    jm, tm = _maskers(kind, mask_biases=True)
    with pytest.raises(NotImplementedError, match="mask_biases"):
        jm.init({}, jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="mask_biases"):
        tm.init({})


# ------------------------------------------------- state carried across

def test_gate_shapes_match_jax(both):
    """The port's own init gives the JAX shapes (in the torch layout), and
    the carried gates keep them (`mask_state_from_jax`'s `.T` leaves ()
    and (H,) as they are)."""
    masker, jstate = both["masker"], both["jstate"]
    own, own_thr = masker.init(both["state"].frozen,
                               torch.Generator().manual_seed(0))
    gate = () if both["kind"] == "layers" else (4,)
    n_structured = 0
    for spec in masker.specs:
        want = _t(spec, jstate.scores[spec.key]).shape
        assert tuple(own[spec.key].shape) == want, spec.key
        assert tuple(both["carried"]["scores"][spec.key].shape) == want
        if masker._is_structured(spec):
            n_structured += 1
            assert want == gate
            assert float(own_thr[spec.key]) == pytest.approx(1e-2)
            assert (own[spec.key].abs() < masker.init_scale).all()
    assert n_structured > 0


def test_apply_masks_exact_on_carried_state(both):
    masker, jmasker = both["masker"], both["jmasker"]
    jstate, carried = both["jstate"], both["carried"]
    params = jstage2.merge_params(jstate.frozen_params, jstate.train_params)
    jmasked = jmasker.apply_masks(params, jstate.scores, jstate.thresholds)
    masked = masker.apply_masks(carried["params"], carried["scores"],
                                carried["thresholds"])
    flat = traverse_util.flatten_dict(jmasked, sep="/")
    off = 0
    for spec in masker.specs:
        got = masked[weight_name(spec)].numpy()
        np.testing.assert_array_equal(got, _t(spec, flat[spec.key]),
                                      err_msg=spec.key)
        off += int((got == 0).all(axis=1).sum())
    assert off > 0


@pytest.mark.parametrize("override", [None, 0.5])
def test_reset_thresholds_match_jax(both, override):
    masker, jmasker = both["masker"], both["jmasker"]
    want = jmasker.reset_thresholds(both["jstate"].scores, override)
    got = masker.reset_thresholds(both["carried"]["scores"], override)
    assert set(got) == set(want)
    for spec in masker.specs:
        assert float(got[spec.key]) == float(want[spec.key]), spec.key
        sc = both["carried"]["scores"][spec.key]
        if masker._is_structured(spec) and sc.dim() == 1:
            sp = override if override is not None else 0.7
            assert int((sc <= got[spec.key]).sum()) == max(
                int(sc.numel() * sp), 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_sparsity_report_matches_jax(both, weighted):
    masker, jmasker, jstate = both["masker"], both["jmasker"], both["jstate"]
    jparams = (jstage2.merge_params(jstate.frozen_params,
                                    jstate.train_params)
               if weighted else None)
    tparams = both["carried"]["params"] if weighted else None
    want = jmasker.sparsity_report(jstate.scores, jstate.thresholds,
                                   params=jparams)
    got = masker.sparsity_report(both["carried"]["scores"],
                                 both["carried"]["thresholds"],
                                 params=tparams)
    assert set(got) == set(want)
    for k in got:
        _close(got[k], float(want[k]), k, atol=0, rtol=1e-6)


def test_one_structured_step_matches_jax(both):
    """The loss and the gradients of the head (or matrix) gates, the
    unstructured scores and the classifier, from the carried state."""
    b = _batch(both["jcfg"], 10)
    js, jm, jmasker = both["jstate"], both["jmodel"], both["jmasker"]
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "valid"}

    def loss_fn(trainable):
        params = jstage2.merge_params(js.frozen_params, trainable["train"])
        masked = jmasker.apply_masks(params, trainable["scores"],
                                     js.thresholds)
        logits, pooled = jm.apply({"params": masked}, **jax_inputs(jb),
                                  deterministic=True)
        return jax_loss("lmh", logits=logits, pooled=pooled,
                        labels=jb["labels"], bias=jb["bias"],
                        max_label=jb["max_label"],
                        lmh_params=trainable["train"]["lmh"])

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        {"train": js.train_params, "scores": js.scores})
    fn = stage2.make_loss_and_grads(both["model"], both["masker"],
                                    both["tsc"])
    batch = {k: torch.from_numpy(v) for k, v in b.items()
             if k not in ("valid", "question_id")}
    batch["input_ids"] = batch["input_ids"].long()
    loss, _, grads = fn(both["state"], batch)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    moved = 0
    for spec in both["masker"].specs:
        g = grads[f"scores/{spec.key}"].numpy()
        _close(g, _t(spec, jg["scores"][spec.key]), spec.key)
        moved += both["masker"]._is_structured(spec) and bool(g.any())
    assert moved > 0
    jclf = jg["train"]["classifier"]
    for layer in ("main_0", "main_3"):
        i = layer[-1]
        _close(grads[f"train/classifier/main.{i}.weight_v"].numpy(),
               np.asarray(jclf[layer]["v"]).T, f"{layer}/v")
        _close(grads[f"train/classifier/main.{i}.bias"].numpy(),
               np.asarray(jclf[layer]["bias"]), f"{layer}/bias")


# ----------------------------------------------------------------- CLIs

def _argv(out, *extra):
    return ["--output_dir", str(out), "--tiny", "--device", "cpu",
            "--synthetic", "32", "--train_batch_size", "8",
            "--eval_batch_size", "8", "--num_train_epochs", "1",
            "--logging_steps", "2", "--save_steps", "2", "--dtype",
            "float32", "--seed", "0", "--do_train", *extra]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("structured")
    runs = {kind: prune_debias_vqa.main(_argv(root / kind, *(
        () if kind == "none" else ("--structured_masking", kind))))
        for kind in ("none", "heads", "layers")}
    return root, runs


def test_cli_heads_exports(cli_runs):
    root, runs = cli_runs
    summary = runs["heads"]
    assert summary["step"] == 4 and all(np.isfinite(summary["losses"]))
    cfg = LxmertConfig.tiny()
    plain = torch.load(root / "none" / "mask.pt", weights_only=True)
    heads = torch.load(root / "heads" / "mask.pt", weights_only=True)
    assert list(heads) == list(plain)
    for name, m in heads.items():
        assert m.shape == plain[name].shape and m.dtype == torch.bool
    state = summary["state"]
    masker = tst.StructuredMasker.create(
        lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers),
        ModalSparsity.from_compression(*SP))
    gates = {s.key: state.scores[s.key] > state.thresholds[s.key]
             for s in masker.specs if masker._is_structured(s)}
    hs = cfg.hidden_size // cfg.num_attention_heads
    want = np.zeros((cfg.l_layers, cfg.num_attention_heads), np.float32)
    for spec in masker.specs:
        if spec.key not in gates:
            continue
        m = heads[f"{spec.torch_name}.weight"].reshape(
            cfg.num_attention_heads, hs, -1)
        # each head's row block is all 0 or all 1, and equals its gate
        assert (m.all(dim=(1, 2)) | ~m.any(dim=(1, 2))).all(), spec.key
        assert torch.equal(m[:, 0, 0], gates[spec.key]), spec.key
        if ".encoder.layer." in spec.torch_name:
            layer = int(spec.torch_name.split(".encoder.layer.")[1][0])
            want[layer] = np.maximum(want[layer], gates[spec.key].numpy())
    hm = np.load(root / "heads" / "head_mask.npy")
    assert hm.dtype == np.float32 and hm.shape == want.shape
    np.testing.assert_array_equal(hm, want)
    assert not (root / "none" / "head_mask.npy").exists()


def test_both_packages_compact_the_port_head_mask(cli_runs):
    root, _ = cli_runs
    hm = np.load(root / "heads" / "head_mask.npy")
    cfg = JaxConfig.tiny()
    b = _batch(cfg, 0)
    params = JaxLxmert(cfg).init(
        jax.random.PRNGKey(2), input_ids=jnp.asarray(b["input_ids"]),
        visual_feats=jnp.asarray(b["visual_feats"]),
        visual_pos=jnp.asarray(b["visual_pos"]))["params"]
    jp, nj = jcomp.compact_lang_heads(params, hm, cfg.head_size)
    tp, nt = tcomp.compact_lang_heads(
        state_dict_from_jax(jax.tree.map(np.asarray, params)), hm,
        cfg.head_size)
    assert nt == nj
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp))
    assert set(tp) == set(want)
    for k, v in want.items():
        assert torch.equal(tp[k], v), k


def test_cli_layers_exports(cli_runs):
    root, runs = cli_runs
    summary = runs["layers"]
    assert summary["step"] == 4 and all(np.isfinite(summary["losses"]))
    state = summary["state"]
    masks = torch.load(root / "layers" / "mask.pt", weights_only=True)
    scalar = [k for k, s in state.scores.items() if s.dim() == 0]
    assert scalar
    cfg = LxmertConfig.tiny()
    specs = {s.key: s for s in lxmert_mask_specs(
        cfg.l_layers, cfg.r_layers, cfg.x_layers)}
    for key in scalar:
        m = masks[f"{specs[key].torch_name}.weight"]
        assert m.all() or not m.any(), key
        assert bool(m.all()) == bool(state.scores[key]
                                     > state.thresholds[key]), key
    assert not (root / "layers" / "head_mask.npy").exists()


def test_resume_from_a_structured_checkpoint(cli_runs, tmp_path):
    root, runs = cli_runs
    resumed = prune_debias_vqa.main(_argv(
        tmp_path / "resumed", "--structured_masking", "heads",
        "--resume_from", str(root / "heads" / "ckpt_4")))
    assert resumed["step"] == 8
    raw = torch.load(root / "heads" / "ckpt_4", weights_only=True)
    assert {tuple(t.shape) for k, t in raw["scores"].items()
            if "self" in k} == {(4,)}
    for k, t in resumed["state"].scores.items():
        assert t.shape == raw["scores"][k].shape, k
    with pytest.raises(ValueError, match="shape"):
        prune_debias_vqa.main(_argv(
            tmp_path / "wrong", "--structured_masking", "layers",
            "--resume_from", str(root / "heads" / "ckpt_4")))


def test_no_language_gates_writes_no_head_mask(tmp_path):
    summary = prune_debias_vqa.main(_argv(
        tmp_path, "--structured_masking", "heads",
        "--structured_masking_types", "x_layers"))
    assert summary["step"] == 4
    assert not (tmp_path / "head_mask.npy").exists()
    assert (tmp_path / "mask.pt").exists()


def test_prune_debias_vqavs_structured_heads(tmp_path):
    from tests.test_dress_rehearsal_vqavs import _fabricate

    _fabricate(tmp_path)
    out = tmp_path / "vs"
    summary = prune_debias_vqavs.main([
        "--output_dir", str(out), "--tiny", "--device", "cpu",
        "--dataroot", str(tmp_path),
        "--img_root", str(tmp_path / "vqa_img_feature_trainval.pickle"),
        "--vocab_file", str(tmp_path / "vocab.txt"),
        "--train_batch_size", "8", "--eval_batch_size", "8",
        "--num_train_epochs", "1", "--logging_steps", "2",
        "--save_steps", "2", "--dtype", "float32", "--do_train",
        "--evaluate_during_training", "--structured_masking", "heads"])
    assert summary["step"] == 4 and all(np.isfinite(summary["losses"]))
    hm = np.load(out / "head_mask.npy")
    assert hm.shape == (2, 4) and set(np.unique(hm)) <= {0.0, 1.0}
    assert (out / "prefictions_VQAvs_test.json").read_bytes() == (
        out / "test.json").read_bytes()


def test_chain_stage1_structured_stage2_stage3(tmp_path):
    """Stage 1 -> structured stage 2 from its .bin -> stage 3 compacted by
    the trained head_mask.npy."""
    common = ["--tiny", "--device", "cpu", "--synthetic", "32",
              "--train_batch_size", "8", "--eval_batch_size", "8",
              "--num_train_epochs", "1", "--dtype", "float32", "--seed", "0",
              "--do_train"]
    s1 = run_vqa_stage1.main(["--output_dir", str(tmp_path / "s1"),
                              "--FT_type", "lmh", *common])
    s2 = prune_debias_vqa.main([
        "--output_dir", str(tmp_path / "s2"), "--stage1_ckpt", s1["bin"],
        "--structured_masking", "heads", "--logging_steps", "2", *common])
    hm_path = tmp_path / "s2" / "head_mask.npy"
    hm = np.load(hm_path)
    s3 = run_vqa_stage3.main([
        "--output_dir", str(tmp_path / "s3"), "--stage1_ckpt", s1["bin"],
        "--head_mask_npy", str(hm_path), "--do_eval", *common])
    assert all(np.isfinite(s2["losses"] + s3["losses"]))
    kept = min(-(-int(hm.sum(axis=1).max()) // 2) * 2, 4)
    assert s3["lang_num_heads"] == kept
    assert s3["state"].params[
        "lxmert.encoder.layer.0.attention.self.query.weight"
    ].shape[0] == kept * 8
    assert os.path.exists(tmp_path / "s3" / "run_FT_trainedMask.bin")



def test_trajectory_matches_jax(both):
    """Four steps with a threshold reset after the second and the fourth,
    from the carried state: per-step losses rtol 1e-4, and after the last
    reset the same structured gates on and off as JAX's."""
    batches = [_batch(both["jcfg"], 20 + i) for i in range(4)]
    jmasker, masker = both["jmasker"], both["masker"]
    jstep = jstage2.make_train_step(both["jmodel"], jmasker, both["jtx"],
                                    both["jsc"])
    jreset = jstage2.make_threshold_reset(jmasker)
    js = jax.tree.map(jnp.array, both["jstate"])  # the step donates
    state, tx = both["port_state"]()
    step = stage2.make_train_step(both["model"], masker, tx, both["tsc"])
    reset = stage2.make_threshold_reset(masker)
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()
                            if k != "valid"})
        tb = {k: torch.from_numpy(v) for k, v in b.items()
              if k not in ("valid", "question_id")}
        tb["input_ids"] = tb["input_ids"].long()
        state, m = step(state, tb)
        jlosses.append(float(jm.loss))
        losses.append(float(m.loss))
        if i in (1, 3):
            js, state = jreset(js), reset(state)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for spec in masker.specs:
        if not masker._is_structured(spec):
            continue
        got = (state.scores[spec.key] > state.thresholds[spec.key]).numpy()
        want = np.asarray(js.scores[spec.key]
                          > js.thresholds[spec.key])
        np.testing.assert_array_equal(got, want, err_msg=spec.key)
