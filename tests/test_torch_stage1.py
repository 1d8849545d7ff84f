"""Stages 1 and 3 as a whole: the port's train step
(crvqa_tpu_torch/train/stage1.py) vs `crvqa_tpu.train.stage1`, from one
state carried across (`core/convert.carry_into_stage1_state`), and the
pieces stage 3 adds.

Setup: the tiny LXMERT with every dropout 0 and fp32 compute, the same
synthetic numpy batches on both sides (JAX's attention on its XLA path;
the port's on its plain version, which the CPU takes).

Tolerances, fp32: losses rtol 1e-5 (one step) and 1e-4 (a trajectory);
gradients atol 1e-6 + rtol 1e-4 (the same math summed in another order
through 7 layers). Adam's first steps move each parameter by about +-lr
whatever its gradient's size, so a parameter whose gradient is within
rounding of zero may step the other way: parameters are held to
2 * lr * steps. The Adam twins are held to optax on given gradients:
1e-6 (fp32 moments) and 5e-4 (bf16 moments, the JAX package's own bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crvqa_tpu.cli.common import lxmert_uniform_masker as jax_uniform_masker
from crvqa_tpu.data import synthetic_batch
from crvqa_tpu.masking import magnitude_masks as jax_magnitude_masks
from crvqa_tpu.masking import reference_rand_masks as jax_rand_masks
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.train import common as jcommon
from crvqa_tpu.train import stage1 as jstage1
from crvqa_tpu_torch.cli import common as tcommon
from crvqa_tpu_torch.core.convert import (carry_into_stage1_state,
                                          state_dict_from_jax)
from crvqa_tpu_torch.masking.masker import (magnitude_masks,
                                            reference_rand_masks, weight_name)
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.train import common, stage1
from crvqa_tpu_torch.train.stage2 import lxmert_meta_model
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
LR = 1e-3


def _batches(cfg, n, bs=4, seed0=0):
    return [synthetic_batch(batch_size=bs, seed=seed0 + i,
                            vocab_size=cfg.vocab_size, ans_num=cfg.ans_num,
                            feat_dim=cfg.visual_feat_dim,
                            pos_dim=cfg.visual_pos_dim) for i in range(n)]


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items() if k != "valid"}


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
    tcfg = LxmertConfig.tiny(**NO_DROPOUT)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, tcfg=tcfg,
                model=lxmert_meta_model(tcfg))


def _configs(both, ft_type, **kw):
    common_kw = dict(ft_type=ft_type, learning_rate=LR, warmup_steps=2,
                     total_steps=20, hidden_size=both["jcfg"].hidden_size)
    common_kw.update(kw)
    return jstage1.Stage1Config(**common_kw), stage1.Stage1Config(**common_kw)


def _pair(both, ft_type, masks=None, **kw):
    """A JAX state and a port state carried from it, with their steps."""
    jsc, tsc = _configs(both, ft_type, **kw)
    jstate, tx = jstage1.init_state(both["params"], jsc,
                                    jax.random.PRNGKey(1))
    jstep = jstage1.make_train_step(both["jmodel"], jsc, tx)
    params = state_dict_from_jax(jax.tree.map(np.asarray, both["params"]))
    tstate, ttx = stage1.init_state(params, tsc, seed=0, device="cpu",
                                    masks=masks)
    carry_into_stage1_state(
        tstate, jax.tree.map(np.asarray, jstate.params),
        None if jstate.lmh_params is None
        else jax.tree.map(np.asarray, jstate.lmh_params))
    return jstate, jstep, tstate, stage1.make_train_step(both["model"], tsc,
                                                         ttx), tsc


def _params_close(tstate, jparams, atol, what):
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for name, t in want.items():
        np.testing.assert_allclose(tstate.params[name].detach().numpy(),
                                   t.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{what}: {name}")


def _first_moment(opt_state):
    """mu of the Adam state inside an optax chain's state."""
    for part in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(part, "mu"):
            return part.mu
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("ft_type", ["normal", "lmh", "lpf", "rubi"])
def test_one_step_and_a_trajectory_match(both, ft_type):
    """One step: loss, score, the first Adam moment ((1 - b1) times each
    clipped gradient) and the parameters; then three more steps (the
    warm-up ends at step 2): losses and parameters."""
    jstate, jstep, tstate, tstep, _ = _pair(both, ft_type)
    batches = _batches(both["jcfg"], 4, seed0=10)
    losses, jlosses = [], []
    for b in batches:
        tstate, m = tstep(tstate, _torch_batch(b))
        jstate, jm = jstep(jstate, _jax_batch(b))
        losses.append(float(m.loss))
        jlosses.append(float(jm.loss))
        if len(losses) > 1:
            continue
        np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
        assert float(m.score) == float(jm.score)
        mu = _first_moment(jstate.opt_state)["params"]
        for name, t in state_dict_from_jax(jax.tree.map(np.asarray,
                                                        mu)).items():
            np.testing.assert_allclose(
                tstate.opt_state.mu[f"params/{name}"].numpy(), t.numpy(),
                rtol=1e-4, atol=1e-7, err_msg=name)
        _params_close(tstate, jstate.params, 2 * LR, "after one step")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _params_close(tstate, jstate.params, 2 * LR * len(batches),
                  "after four steps")
    assert tstate.step == int(jstate.step) == len(batches)


def test_gradient_accumulation_matches_the_full_batch(both):
    _, _, full, _, cfg = _pair(both, "lmh")
    _, _, acc, _, cfg2 = _pair(both, "lmh", grad_accum_steps=2)
    batch = _torch_batch(_batches(both["jcfg"], 1, bs=8, seed0=20)[0])
    l1, s1, g1 = stage1.make_loss_and_grads(both["model"], cfg)(full, batch)
    l2, s2, g2 = stage1.make_loss_and_grads(both["model"], cfg2)(acc, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    assert float(s1) == float(s2)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("train_lmh", [False, True])
def test_lmh_is_stepped_only_with_train_lmh(both, train_lmh):
    """The reference keeps LearnedMixin outside its optimizer and its clip
    (`run_vqa_stage1.py:341-362`)."""
    _, _, state, step, cfg = _pair(both, "lmh", train_lmh=train_lmh,
                                   warmup_steps=0)
    before = {k: v.detach().clone() for k, v in state.lmh_params.items()}
    assert any(k.startswith("lmh/") for k in
               stage1.trainable(state, cfg)) == train_lmh
    step(state, _torch_batch(_batches(both["jcfg"], 1, seed0=30)[0]))
    moved = any(not torch.equal(before[k], v)
                for k, v in state.lmh_params.items())
    assert moved == train_lmh


def test_stage3_pruned_weights_stay_zero(both):
    """Constant masks multiply the weights in every forward (the port's
    `prune.CustomFromMask`): masked entries get zero gradient and Adam
    never moves them."""
    masker = tcommon.lxmert_uniform_masker(both["tcfg"], 0.7)
    params = state_dict_from_jax(jax.tree.map(np.asarray, both["params"]))
    masks = magnitude_masks(params, masker.specs, masker.zerorate_dict)
    params = masker.prune_params(params, masks)
    _, cfg = _configs(both, "lmh")
    state, tx = stage1.init_state(params, cfg, seed=0, device="cpu",
                                  masks=masks)
    step = stage1.make_train_step(both["model"], cfg, tx)
    for b in _batches(both["jcfg"], 3, seed0=40):
        step(state, _torch_batch(b))
    moved = 0
    for name, m in masks.items():
        w = state.params[name].detach()
        assert not w[~m].any(), name  # pruned: still exactly 0
        moved += bool((w[m] != params[name][m]).any())
    # kept entries train (but the last cross layer's visual branch, which
    # never reaches the logits)
    assert moved >= len(masks) - 6
    logits = stage1.make_eval_step(both["model"])(
        state, _torch_batch(_batches(both["jcfg"], 1)[0]))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("scope", ["reference", "all"])
def test_rand_masks_equal_the_jax_masks(both, scope):
    jmasker = jax_uniform_masker(both["jcfg"], 0.7)
    masker = tcommon.lxmert_uniform_masker(both["tcfg"], 0.7)
    params = state_dict_from_jax(jax.tree.map(np.asarray, both["params"]))
    if scope == "reference":
        want = jax_rand_masks(both["params"], list(jmasker.specs), 0.7)
        got = reference_rand_masks(params, masker.specs, 0.7)
    else:
        want = jax_magnitude_masks(both["params"], list(jmasker.specs),
                                   jmasker.zerorate_dict)
        got = magnitude_masks(params, masker.specs, masker.zerorate_dict)
    assert len(got) == len(want) == len(masker.specs)
    for spec in masker.specs:
        m = np.asarray(want[spec.key])
        np.testing.assert_array_equal(
            got[weight_name(spec)].numpy(), m if spec.is_embedding else m.T,
            err_msg=spec.key)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adam_matches_make_adam(moment_dtype):
    """Six clipped steps on given gradients (the first ones clipped) with
    the warm-up schedule."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(32, 16)).astype(np.float32),
              "b": np.zeros((16,), np.float32)}
    jtx = jcommon.make_adam(5e-3, warmup_steps=3, total_steps=50,
                            moment_dtype=(jnp.bfloat16 if moment_dtype
                                          else None))
    ttx = common.make_adam(5e-3, warmup_steps=3, total_steps=50,
                           moment_dtype=(torch.bfloat16 if moment_dtype
                                         else None))
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = ttx.init(tp)
    for i in range(6):
        scale = 3.0 if i < 2 else 0.1  # norms above and below the clip
        g = {k: (np.sin(v + i) * scale).astype(np.float32)
             for k, v in params.items()}
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        ttx.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert ts.count == 6
    for k in params:
        if moment_dtype:
            assert ts.mu[k].dtype == torch.bfloat16
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=5e-4 if moment_dtype else 1e-6,
                                   err_msg=k)


def test_window_equals_its_steps_one_by_one(both):
    """`make_multi_step` over a window of 3 stacked batches against the
    same 3 steps one by one, from two copies of one state: the losses,
    scores, parameters, moments and step bit for bit."""
    _, _, one, step, cfg = _pair(both, "lmh", warmup_steps=0)
    _, _, win, _, _ = _pair(both, "lmh", warmup_steps=0)
    tx = stage1.init_state(win.params, cfg, seed=0, device="cpu")[1]
    batches = [_torch_batch(b) for b in _batches(both["jcfg"], 3, seed0=50)]
    single = [step(one, b)[1] for b in batches]
    window = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    win, losses, scores = stage1.make_multi_step(both["model"], cfg, tx,
                                                 3)(win, window)
    assert torch.equal(losses, torch.stack([m.loss for m in single]))
    assert torch.equal(scores, torch.stack([m.score for m in single]))
    assert win.step == one.step == 3
    for name, p in one.params.items():
        assert torch.equal(win.params[name], p), name
    for k, m in one.opt_state.mu.items():
        assert torch.equal(win.opt_state.mu[k], m), k
        assert torch.equal(win.opt_state.nu[k], one.opt_state.nu[k]), k
