"""The stage-2 slice as a whole: the port's train step
(crvqa_tpu_torch/train/stage2.py) vs `crvqa_tpu.train.stage2`, from one
state carried across (`core/convert.stage2_from_jax`).

Setup: the tiny LXMERT with every dropout 0 and fp32 compute, the LMH loss
at compression 0.3/0.3/0.3 and zero rate 0.7 with the magnitude init, the
same synthetic numpy batches on both sides (JAX's attention on its XLA
path; the port's on its plain version, which the CPU takes).

Tolerances, fp32: loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4 (the
same math summed in another order through 7 layers). Over a trajectory,
AdamW's first steps move each score by about +-lr whatever its gradient's
size, so a score whose gradient is within rounding of zero may step the
other way: scores are held to atol 2 * lr * steps, and after a threshold
reset at least 99.5% of the mask entries agree.

With dropout on, two runs from the same --seed give identical losses
(every draw comes from generators seeded by it).

A window of steps (`make_multi_step`, `--steps_per_dispatch`) equals its
steps taken one by one bit for bit, matches the JAX window at the
trajectory's tolerances, and the CLI's windows log, reset and checkpoint
at the JAX CLI's steps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.cli import prune_debias_vqa as jax_cli
from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.losses import dispatch_loss as jax_loss
from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import lxmert_mask_specs as jax_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu.train.common import model_inputs as jax_inputs
from crvqa_tpu_torch.cli import prune_debias_vqa
from crvqa_tpu_torch.core.convert import carry_into_state, stage2_from_jax
from crvqa_tpu_torch.masking.masker import Masker
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.train import stage2
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
LR = 1e-3


def _batches(cfg, n, seed0=0):
    return [synthetic_batch(batch_size=4, seed=seed0 + i,
                            vocab_size=cfg.vocab_size, ans_num=cfg.ans_num,
                            feat_dim=cfg.visual_feat_dim,
                            pos_dim=cfg.visual_pos_dim) for i in range(n)]


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()
           if k not in ("valid", "question_id")}
    out["input_ids"] = out["input_ids"].long()
    return out


@pytest.fixture(scope="module")
def both():
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    jmodel = JaxLxmert(jcfg)
    b0 = _batches(jcfg, 1)[0]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(b0["input_ids"]),
        visual_feats=jnp.asarray(b0["visual_feats"]),
        visual_pos=jnp.asarray(b0["visual_pos"]))["params"]
    sp = (0.3, 0.3, 0.3, 0.7)
    jmasker = JaxMasker.create(
        jax_specs(jcfg.l_layers, jcfg.r_layers, jcfg.x_layers),
        JaxSparsity.from_compression(*sp), controlled_init="magnitude")
    jsc = jstage2.Stage2Config(masker_type="lmh", learning_rate=LR,
                               total_steps=20, hidden_size=jcfg.hidden_size)
    jstate, tx = jstage2.init_state(jmodel, jmasker, params, jsc,
                                    jax.random.PRNGKey(1))
    carried = stage2_from_jax(
        jax.tree.map(np.asarray, jstate.frozen_params),
        jax.tree.map(np.asarray, jstate.train_params),
        jax.tree.map(np.asarray, jstate.scores),
        jax.tree.map(np.asarray, jstate.thresholds), jmasker.specs)

    tcfg = LxmertConfig.tiny(**NO_DROPOUT)
    masker = Masker.create(
        lxmert_mask_specs(tcfg.l_layers, tcfg.r_layers, tcfg.x_layers),
        ModalSparsity.from_compression(*sp), controlled_init="magnitude")
    tsc = stage2.Stage2Config(masker_type="lmh", learning_rate=LR,
                              total_steps=20, hidden_size=tcfg.hidden_size)
    model = stage2.lxmert_meta_model(tcfg)

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


def test_state_carried_across(both):
    state, _ = both["port_state"]()
    js = both["jstate"]
    for spec in both["masker"].specs:
        want = np.asarray(js.scores[spec.key])
        got = state.scores[spec.key].detach().numpy()
        np.testing.assert_array_equal(got, want if spec.is_embedding
                                      else want.T)
    # the port's own controlled init already equals the carried scores
    own, _ = both["masker"].init(state.frozen)
    for k, v in own.items():
        torch.testing.assert_close(v, state.scores[k].detach(), rtol=0,
                                   atol=0)


def test_one_step_loss_and_gradients_match_jax(both):
    b = _batches(both["jcfg"], 1, seed0=10)[0]
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
    state, _ = both["port_state"]()
    fn = stage2.make_loss_and_grads(both["model"], both["masker"],
                                    both["tsc"])
    loss, _, grads = fn(state, _torch_batch(b))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for spec in both["masker"].specs:
        want = np.asarray(jg["scores"][spec.key])
        _close(grads[f"scores/{spec.key}"].numpy(),
               want if spec.is_embedding else want.T, spec.key)
    jclf = jg["train"]["classifier"]
    for layer in ("main_0", "main_3"):
        i = layer[-1]
        _close(grads[f"train/classifier/main.{i}.weight_v"].numpy(),
               np.asarray(jclf[layer]["v"]).T, f"{layer}/v")
        _close(grads[f"train/classifier/main.{i}.weight_g"].numpy(),
               np.asarray(jclf[layer]["g"]).reshape(()), f"{layer}/g")
        _close(grads[f"train/classifier/main.{i}.bias"].numpy(),
               np.asarray(jclf[layer]["bias"]), f"{layer}/bias")


def test_trajectory_matches_jax(both):
    """Four steps, a threshold reset, two more steps and another reset:
    per-step losses, scores, thresholds, masks and zero rates against
    JAX."""
    batches = _batches(both["jcfg"], 6, seed0=20)
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
        if i in (3, 5):  # mid-run, and before the final comparison
            js, state = jreset(js), reset(state)
    assert state.step == int(js.step) == 6
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    atol = 2 * LR * len(batches)
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
    for modality in ("Lang", "Vis", "Fus", "P"):
        assert abs(report[modality] - 0.7) < 0.02


def _run(tmp_path, tag, seed, extra=()):
    out = tmp_path / tag
    return prune_debias_vqa.main([
        "--output_dir", str(out), "--tiny", "--device", "cpu",
        "--synthetic", "24", "--train_batch_size", "4",
        "--eval_batch_size", "8", "--num_train_epochs", "1",
        "--logging_steps", "3", "--save_steps", "100", "--do_train",
        "--dtype", "float32", "--seed", str(seed), *extra])


def test_dropout_runs_are_reproducible_from_the_seed(tmp_path):
    """Dropout on (hidden 0.1, attention 0.1, classifier 0.5, the config's
    defaults): same seed, identical losses; another seed, other losses."""
    a = _run(tmp_path, "a", 5)
    b = _run(tmp_path, "b", 5)
    c = _run(tmp_path, "c", 6)
    assert len(a["losses"]) == 6 and all(np.isfinite(a["losses"]))
    assert a["losses"] == b["losses"]
    assert a["losses"] != c["losses"]


def test_grad_accumulation_and_bf16_moments_run(tmp_path):
    out = _run(tmp_path, "acc", 7, ["--gradient_accumulation_steps", "2",
                                   "--moment_dtype", "bfloat16",
                                   "--name_of_masker", "MaskedLinear2",
                                   "--Masker_type", "poe"])
    assert len(out["losses"]) == 6 and all(np.isfinite(out["losses"]))


def _window(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def test_window_equals_its_steps_one_by_one(both):
    """A window of 3 against the same 3 steps one by one, from two copies
    of one state, fp32: the losses, scores, scores and moments after the
    window, the thresholds of a reset after it, and the step, bit for
    bit."""
    batches = [_torch_batch(b) for b in _batches(both["jcfg"], 3, seed0=60)]
    one, opt = both["port_state"]()
    win, _ = both["port_state"]()
    step = stage2.make_train_step(both["model"], both["masker"], opt,
                                  both["tsc"])
    single = [step(one, b)[1] for b in batches]
    multi = stage2.make_multi_step(both["model"], both["masker"], opt,
                                   both["tsc"], 3)
    win, losses, scores = multi(win, _window(batches))
    assert torch.equal(losses, torch.stack([m.loss for m in single]))
    assert torch.equal(scores, torch.stack([m.score for m in single]))
    assert win.step == one.step == 3
    reset = stage2.make_threshold_reset(both["masker"])
    one, win = reset(one), reset(win)
    for k, v in one.scores.items():
        assert torch.equal(win.scores[k], v), k
        assert torch.equal(win.thresholds[k], one.thresholds[k]), k
    for k, v in one.opt_state.mu.items():
        assert torch.equal(win.opt_state.mu[k], v), k
        assert torch.equal(win.opt_state.nu[k], one.opt_state.nu[k]), k


def test_window_matches_the_jax_window(both):
    """A window of 3 against the JAX package's `make_multi_step` (one
    `lax.scan`) over the same stacked batches, at the trajectory's
    tolerances."""
    batches = _batches(both["jcfg"], 3, seed0=70)
    jmulti = jstage2.make_multi_step(both["jmodel"], both["jmasker"],
                                     both["tx"], both["jsc"], 3)
    js = jax.tree.map(jnp.array, both["jstate"])  # the window donates
    js, jlosses, jscores = jmulti(js, {
        k: jnp.stack([jnp.asarray(b[k]) for b in batches])
        for k in batches[0] if k != "valid"})
    state, opt = both["port_state"]()
    multi = stage2.make_multi_step(both["model"], both["masker"], opt,
                                   both["tsc"], 3)
    state, losses, scores = multi(state, _window(
        [_torch_batch(b) for b in batches]))
    assert state.step == int(js.step) == 3
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5)
    atol = 2 * LR * len(batches)
    for spec in both["masker"].specs:
        want = np.asarray(js.scores[spec.key])
        _close(state.scores[spec.key].detach().numpy(),
               want if spec.is_embedding else want.T, spec.key, atol=atol,
               rtol=0)


def _logged(out):
    with open(out / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    return ([x["step"] for x in lines if "loss" in x],
            [x["step"] for x in lines if "final_eval_acc" in x])


def test_cli_windows_log_and_save_at_the_jax_cli_steps(tmp_path):
    """--steps_per_dispatch 2 --logging_steps 3 --save_steps 3 over 5
    batches, in both packages' CLIs: the windows end at steps 2 and 4, so
    the reset, the log and ckpt_4 fire at 4 only; the fifth batch is a
    single step with no log; the final step is 5."""
    argv = ["--tiny", "--synthetic", "40", "--train_batch_size", "8",
            "--eval_batch_size", "8", "--num_train_epochs", "1",
            "--steps_per_dispatch", "2", "--logging_steps", "3",
            "--save_steps", "3", "--dtype", "float32", "--do_train",
            "--do_eval", "--seed", "1"]
    jax_cli.main(["--output_dir", str(tmp_path / "jax"), *argv])
    out = prune_debias_vqa.main(["--output_dir", str(tmp_path / "port"),
                                 "--device", "cpu", *argv])
    assert _logged(tmp_path / "port") == _logged(tmp_path / "jax") == (
        [4], [5])
    ckpts = lambda d: sorted(p.name for p in d.glob("ckpt_*")
                             if not p.name.endswith(".json"))
    assert ckpts(tmp_path / "port") == ckpts(tmp_path / "jax") == ["ckpt_4"]
    assert out["step"] == 5 and len(out["losses"]) == 5
