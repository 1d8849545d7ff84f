"""mPLUG training of the port (crvqa_tpu_torch/train/mplug_train.py, the
training entries of models/mplug, masking/sparsity_control.py and the
grouped AdamW of train/common.py) vs the JAX package on
`MPlugConfig.tiny()`, fp32, every dropout at 0 (flax's PRNG dropout cannot
be reproduced; the kernels' counter-hash dropout is compared at the op
level in test_torch_midseq_attention.py).

Both sides are built by their CLIs' own build functions from one argv; the
JAX state (params, scores, thresholds, twins, Adam moments, step) is carried
into the port with `core.convert.mplug_train_state_from_jax`, and the same
numpy batches go through both train steps.

Tolerances: losses within 1e-5 (fp32 sums in another order); after ONE step
scores and parameters within 1e-6 (the learning rate is about 1e-5 and Adam's
update has size lr); after four steps within 4e-5, the four learning rates
summed: Adam divides by sqrt(v), so a gradient entry at rounding level can
take a full step either way, and a handful of entries per matrix do.
Schedules within 1e-6 relative (jnp float32 against Python floats).
The activation-checkpointing and AdaHessian checks are in
tests/test_torch_mplug_train_opts.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from crvqa_tpu.cli import vqa_mplug as jcli
from crvqa_tpu.data.mplug_data import synthetic_mplug_batch
from crvqa_tpu.masking import sparsity_control as jsc
from crvqa_tpu.models.mplug import bert as jbert
from crvqa_tpu.models.mplug import mplug as jmplug
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.cli import vqa_mplug as tcli
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.masking import sparsity_control as tsc
from crvqa_tpu_torch.models.mplug import MPlug, momentum_update_
from crvqa_tpu_torch.models.mplug import bert as tbert
from crvqa_tpu_torch.train import mplug_train as ttrain
from crvqa_tpu_torch.train.common import GroupAdamW
from torch.func import functional_call
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

BATCH = 3
# the distill modes' cases run in tests/test_torch_mplug_train_distill.py
MODES = [("mask", False), ("full", False)]
IDS = ["mask", "full"]
DISTILL_MODES = [("mask", True), ("full", True)]
DISTILL_IDS = ["mask-distill", "full-distill"]
# epoch-granular cosine over 2 steps per epoch: the trajectory crosses an
# epoch boundary, and the reset moves the target (init 0.3 -> 0.5)
TRAIN_KW = dict(steps_per_epoch=2, epochs=2, warmup_epochs=1, total_steps=4,
                warmup_steps=2)


def _argv(tmp, mode, distill, extra=()):
    return ["--tiny", "--dtype", "float32", "--output_dir", str(tmp),
            "--mode", mode, "--seed", "3", "--distill", str(distill),
            "--hidden_dropout_prob", "0", "--attention_probs_dropout_prob",
            "0", "--init_sparsity", "0.3", *extra]


def _np(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _batch(seed, vocab):
    b = synthetic_mplug_batch(batch_size=BATCH, image_res=32,
                              vocab_size=vocab, seed=seed, uint8_images=True)
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "qid"}
    tb = {k: torch.from_numpy(v) for k, v in b.items() if k != "qid"}
    for k in ("question_ids", "answer_ids"):
        tb[k] = tb[k].long()
    return jb, tb


def _moments(opt_state, which):
    """{group: one Adam moment over the trainable tree, None where the leaf
    is the other group's} out of the JAX two-group optimizer state."""
    masked = lambda x: isinstance(x, optax.MaskedNode)
    out = {}
    for group, st in opt_state[1].inner_states.items():
        adam = st.inner_state[0]
        out[group] = jax.tree.map(
            lambda x: None if masked(x) else np.asarray(x),
            getattr(adam, which), is_leaf=masked)
    return out


def _carry(jstate, tstate, mode, specs):
    convert.mplug_train_state_from_jax(tstate, dict(
        step=int(jstate.step), params=_np(jstate.params),
        scores=_np(jstate.scores), thresholds=_np(jstate.thresholds),
        params_m=_np(jstate.params_m), scores_m=_np(jstate.scores_m),
        thresholds_m=_np(jstate.thresholds_m),
        mu=_moments(jstate.opt_state, "mu"),
        nu=_moments(jstate.opt_state, "nu")), mode, specs)


_PARAMS: dict = {}  # the JAX initial params by model config


class Side:
    """Both packages' model, masker, train config, jitted step and reset for
    one (mode, distill), and a JAX state two steps in (so the carried Adam
    moments and step are not their initial zeros). Sides of one model
    config share its jitted init's params."""

    def __init__(self, tmp, mode, distill, extra=()):
        argv = _argv(tmp, mode, distill, extra)
        self.mode = mode
        jargs = jcli.build_parser().parse_args(argv)
        self.jconfig, _, self.jmodel = jcli.build_model(jargs)
        self.jmasker = (jcli.build_masker(jargs, self.jconfig)[0]
                        if mode == "mask" else None)
        vocab = self.jconfig.bert.vocab_size
        self.batches = [_batch(s, vocab) for s in (4, 5, 6, 7, 8, 9)]
        jb = self.batches[0][0]
        rng = jax.random.PRNGKey(3)
        key = repr(self.jconfig)  # the mode does not enter the model
        if key not in _PARAMS:
            _PARAMS[key] = jax.jit(self.jmodel.init)(
                rng, jb["images"], jb["question_ids"], jb["question_mask"],
                jb["answer_ids"], jb["answer_mask"], jb["weights"])["params"]
        self.jparams = _PARAMS[key]
        kw = dict(mode=mode, distill=distill, **TRAIN_KW)
        self.jcfg = jtrain.MPlugTrainConfig(**kw)
        self.tcfg = ttrain.MPlugTrainConfig(**kw)
        jstate, tx = jtrain.init_state(self.jmodel, self.jparams, self.jcfg,
                                       rng, masker=self.jmasker)
        # no donation: the tests keep the states they start from
        self.jstep = jax.jit(jtrain.make_train_step(
            self.jmodel, self.jcfg, tx, masker=self.jmasker).__wrapped__)
        self.jreset = (jtrain.make_threshold_reset(self.jmasker)
                       if self.jmasker else None)
        for jb, _ in self.batches[:2]:
            jstate, _ = self.jstep(jstate, jb)
        self.jstate = jstate

        targs = tcli.build_parser().parse_args(argv + ["--device", "cpu"])
        self.tconfig, _, self.tmodel = tcli.build_model(targs)
        self.tmasker = (tcli.build_masker(targs, self.tconfig)
                        if mode == "mask" else None)
        self.specs = self.tmasker.specs if self.tmasker else None
        self.tstep = ttrain.make_train_step(self.tmodel, self.tcfg,
                                            self.tmasker)
        self.treset = (ttrain.make_threshold_reset(self.tmasker)
                       if self.tmasker else None)

    def port_state(self, jstate):
        """A fresh port training state carrying `jstate`."""
        tstate = ttrain.init_state(
            self.tmodel, convert.mplug_state_dict_from_jax(_np(self.jparams)),
            self.tcfg, "cpu", self.tmasker, seed=3, train=True)
        _carry(jstate, tstate, self.mode, self.specs)
        return tstate

    def assert_states_close(self, jstate, tstate, atol):
        want = convert.mplug_state_dict_from_jax(_np(jstate.params))
        for k, t in want.items():
            np.testing.assert_allclose(
                tstate.params[k].detach().numpy(), t.numpy(), rtol=0,
                atol=atol, err_msg=k)
        for suffix in ("", "_m"):
            js = getattr(jstate, "scores" + suffix)
            if js is None:
                assert getattr(tstate, "scores" + suffix) is None
                continue
            scores, thresholds = convert.mask_state_from_jax(
                _np(js), _np(getattr(jstate, "thresholds" + suffix)),
                self.specs)
            for k, t in scores.items():
                np.testing.assert_allclose(
                    getattr(tstate, "scores" + suffix)[k].detach().numpy(),
                    t.numpy(), rtol=0, atol=atol, err_msg=k + suffix)
                np.testing.assert_allclose(
                    getattr(tstate, "thresholds" + suffix)[k].numpy(),
                    thresholds[k].numpy(), rtol=0, atol=atol,
                    err_msg=k + suffix)
        if jstate.params_m is not None:
            want_m = convert.mplug_state_dict_from_jax(_np(jstate.params_m))
            for k, t in want_m.items():
                np.testing.assert_allclose(tstate.params_m[k].numpy(),
                                           t.numpy(), rtol=0, atol=atol,
                                           err_msg=k + "_m")


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    cache = {}

    def get(mode, distill=False, extra=()):
        key = (mode, distill, tuple(extra))
        if key not in cache:
            cache[key] = Side(
                tmp_path_factory.mktemp(f"{mode}{int(distill)}"), mode,
                distill, extra)
        return cache[key]

    return get


# ------------------------------------------------------------- the model

def _apply_port(side, fn, tb, **kw):
    params = convert.mplug_state_dict_from_jax(_np(side.jparams))
    side.tmodel.eval()
    with torch.no_grad():
        return functional_call(
            side.tmodel, params,
            (fn, tb["images"], tb["question_ids"], tb["question_mask"],
             tb["answer_ids"], tb["answer_mask"]), kw, strict=True)


def test_answer_logits_equal_jax(sides):
    side = sides("full")
    jb, tb = side.batches[0]
    want = side.jmodel.apply(
        {"params": side.jparams}, jb["images"], jb["question_ids"],
        jb["question_mask"], jb["answer_ids"], jb["answer_mask"],
        method=side.jmodel.answer_logits)
    got = _apply_port(side, MPlug.answer_logits, tb)
    assert got.shape == want.shape == (BATCH * 3, 5, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("alpha", [None, 0.4])
def test_training_loss_equals_jax(sides, use_bias, alpha):
    """weights, (1 - bias), / B and the distillation mix."""
    side = sides("full")
    jb, tb = side.batches[1]
    soft = None
    if alpha is not None:
        soft = np.random.default_rng(0).dirichlet(
            np.ones(128), (BATCH * 3, 4)).astype(np.float32)
    want = side.jmodel.apply(
        {"params": side.jparams}, jb["images"], jb["question_ids"],
        jb["question_mask"], jb["answer_ids"], jb["answer_mask"],
        jb["weights"], bias=jb["bias"] if use_bias else None,
        soft_labels=None if soft is None else jnp.asarray(soft),
        alpha=alpha or 0.0)
    params = convert.mplug_state_dict_from_jax(_np(side.jparams))
    side.tmodel.eval()
    with torch.no_grad():
        got = functional_call(
            side.tmodel, params,
            (MPlug.loss, tb["images"], tb["question_ids"],
             tb["question_mask"], tb["answer_ids"], tb["answer_mask"],
             tb["weights"]),
            dict(bias=tb["bias"] if use_bias else None,
                 soft_labels=None if soft is None else torch.from_numpy(soft),
                 alpha=alpha or 0.0), strict=True)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)


def test_soft_label_distill_loss_equals_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 5, 17)).astype(np.float32)
    soft = rng.dirichlet(np.ones(17), (6, 4)).astype(np.float32)
    labels = rng.integers(0, 17, (6, 5))
    labels[:, -1] = 0  # pad tail
    want = jbert.soft_label_distill_loss(jnp.asarray(logits),
                                         jnp.asarray(soft),
                                         jnp.asarray(labels), 0)
    got = tbert.soft_label_distill_loss(torch.from_numpy(logits),
                                        torch.from_numpy(soft),
                                        torch.from_numpy(labels), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_momentum_update_equals_jax():
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=(4, 3)).astype(np.float32) for k in "ab"}
    m = {k: rng.normal(size=(4, 3)).astype(np.float32) for k in "ab"}
    want = jmplug.momentum_update(jax.tree.map(jnp.asarray, p),
                                  jax.tree.map(jnp.asarray, m), 0.995)
    tm = {k: torch.from_numpy(v.copy()) for k, v in m.items()}
    momentum_update_(tm, {k: torch.from_numpy(v) for k, v in p.items()},
                     0.995)
    for k in "ab":
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-7)


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("sched", ["cosine", "tanh", "step"])
def test_timm_epoch_schedule_equals_jax(sched):
    """Every step of three epochs of 350 steps: the warm-up units of epoch
    0 (step_size 100, capped by the epoch's length) and two epoch
    boundaries."""
    kw = dict(warmup_epochs=4, epochs=8, min_lr=1e-6, steps_per_epoch=350,
              decay_rate=0.5 if sched == "step" else 1.0, decay_epochs=2,
              warmup_lr_init=1e-5)
    want = jtrain.timm_epoch_schedule(sched, 3e-5, **kw)
    got = ttrain.timm_epoch_schedule(sched, 3e-5, **kw)
    steps = np.arange(0, 3 * 350 + 5)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               np.asarray(jax.vmap(want)(jnp.asarray(steps))),
                               rtol=1e-6, atol=0)
    # past the warm-up, into the decay and past the cycle's end
    kw.update(steps_per_epoch=2, warmup_epochs=1, epochs=3)
    want = jtrain.timm_epoch_schedule(sched, 3e-5, **kw)
    got = ttrain.timm_epoch_schedule(sched, 3e-5, **kw)
    for s in range(14):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("sched", ["cosine", "tanh", "step"])
def test_step_schedule_equals_jax(sched):
    args = (sched, 3e-5, 7, 40, 1e-6, 0.5, 9)
    want = jtrain.make_lr_schedule(*args)
    got = ttrain.make_lr_schedule(*args)
    for s in range(50):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=1e-12)


def test_plateau_schedule_raises():
    with pytest.raises(ValueError, match="plateau"):
        ttrain.make_lr_schedule("plateau", 1e-5, 1, 10, 1e-6)


@pytest.mark.parametrize("warmup,kw", [
    ("automated_gradual_sparsity", {}),
    ("stepwise_sparsity", {"sparsity_incremental_ratio": 0.2})])
def test_masker_scheduler_equals_jax(warmup, kw):
    """Polled at fractional epochs, as the train loop polls it (stepwise:
    the +1e-9 interval count at 0.1-epoch intervals)."""
    args = dict(final_sparsity=0.7, num_epochs=4, init_sparsity=0.3,
                lambdas_lr=1.0, final_epoch=3, sparsity_warmup=warmup, **kw)
    want, got = jsc.MaskerScheduler(**args), tsc.MaskerScheduler(**args)
    assert got.is_skip == want.is_skip
    for e in np.arange(0, 4.05, 0.05):
        assert got.step(float(e)) == want.step(float(e))
        assert got.is_meet_sparsity() == want.is_meet_sparsity()


def test_stepwise_safety_check_raises():
    with pytest.raises(ValueError, match="Increase initial sparsity"):
        tsc.stepwise_sparsity(0.1, 0.9, 0.5, 0, 1, 0.01)


# ------------------------------------------------------------- optimizer

def _port_names(tree, arrays, mode):
    """{port trainable name: leaf of `tree`} over a JAX trainable tree;
    `arrays` is the tree of the leaves' arrays (the name rule reads their
    rank)."""
    out = {}
    if mode == "mask":
        for k, v in tree["scores"].items():
            out[f"scores/{k}"] = v
        for k, v in tree["head"].items():
            name, _ = convert.mplug_torch_name(
                tuple(k.split("/")), np.asarray(arrays["head"][k]))
            out[f"head/{name}"] = v
        return out
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (path, v), arr in zip(flat, jax.tree.leaves(arrays)):
        name, _ = convert.mplug_torch_name(tuple(p.key for p in path),
                                           np.asarray(arr))
        out[f"params/{name}"] = v
    return out


@pytest.mark.parametrize("mode", ["mask", "full"])
def test_group_labels_and_decay_mask_equal_jax(sides, mode):
    """The port's rules by torch name against the JAX rules by flax path,
    leaf by leaf over the carried trainable tree; the trainable set itself
    (the tied decoder weight is no parameter: neither trained nor
    decayed)."""
    side = sides(mode)
    jstate = side.jstate
    if mode == "mask":
        tree = {"scores": jstate.scores,
                "head": jtrain.split_head_params(jstate.params,
                                                 side.jcfg.head_substrings)}
    else:
        tree = jstate.params
    want_labels = _port_names(jtrain.two_group_labels(tree), tree, mode)
    want_decay = _port_names(jtrain.decay_mask(tree), tree, mode)
    leaves = ttrain.trainable(side.port_state(jstate), side.tcfg)
    assert set(leaves) == set(want_labels)
    assert ttrain.two_group_labels(leaves) == want_labels
    assert ttrain.decay_mask(leaves) == {k: bool(v)
                                         for k, v in want_decay.items()}
    assert not any("decoder.weight" in k for k in leaves)
    assert all(v.requires_grad for v in leaves.values())
    if mode == "mask":
        heads = sorted(k for k in leaves if k.startswith("head/"))
        assert heads == sorted(
            "head/text_decoder.cls.predictions." + n for n in (
                "bias", "transform.dense.weight", "transform.dense.bias",
                "transform.LayerNorm.weight", "transform.LayerNorm.bias"))


def test_decay_mask_names():
    got = ttrain.decay_mask([
        "params/visual_encoder.visual.ln_pre.weight",
        "params/visual_encoder.visual.transformer.resblocks.0.ln_1.weight",
        "params/text_encoder.embeddings.LayerNorm.weight",
        "params/visual_encoder.visual.transformer.resblocks.0.attn."
        "in_proj_bias",
        "scores/text_encoder/layer_0/attention/self/key/kernel",
        "scores/text_encoder/layer_0/attention/self/key/bias",
        "head/text_decoder.cls.predictions.bias"])
    assert list(got.values()) == [True, True, False, False, True, False,
                                  False]


def test_group_adamw_equals_optax_adamw():
    """Five steps of the in-place twin against `optax.adamw` under
    `multi_transform`, two groups with their own schedules, a decay mask."""
    rng = np.random.default_rng(3)
    names = ["params/visual_encoder.a.weight", "params/b.weight",
             "params/b.bias"]
    p0 = {n: rng.normal(size=(5, 4)).astype(np.float32) for n in names}
    s1 = ttrain.timm_epoch_schedule("cosine", 3e-2, 1, 2, 1e-4, 2)
    s2 = ttrain.make_lr_schedule("cosine", 5e-3, 2, 6, 1e-4)
    j1 = jtrain.timm_epoch_schedule("cosine", 3e-2, 1, 2, 1e-4, 2)
    j2 = jtrain.make_lr_schedule("cosine", 5e-3, 2, 6, 1e-4)
    labels = {n: "visual" if "visual_encoder" in n else "body" for n in names}
    decay = {n: not n.endswith("bias") for n in names}
    tx = optax.multi_transform(
        {"body": optax.adamw(j1, weight_decay=0.02, mask=decay),
         "visual": optax.adamw(j2, weight_decay=0.02, mask=decay)}, labels)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jst = tx.init(jp)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    opt = GroupAdamW({"body": s1, "visual": s2}, labels, decay,
                     weight_decay=0.02)
    tst = opt.init(tp)
    for _ in range(5):
        g = {n: rng.normal(size=(5, 4)).astype(np.float32) * 1e-2
             for n in names}
        upd, jst = tx.update({n: jnp.asarray(v) for n, v in g.items()}, jst,
                             jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {n: torch.from_numpy(v) for n, v in g.items()}, tst)
        for n in names:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=0, atol=1e-6, err_msg=n)
    assert tst.count == 5


def test_unported_optimizer_raises():
    """Every name of the factory's table builds (a `lookahead_` prefix
    stripped); a name outside it raises ValueError worded as the JAX
    factory's (tests/test_torch_optim.py holds the arithmetic)."""
    for opt in ("adamp", "lookahead_fusedadamw", "adahessian", "lamb"):
        assert ttrain.make_two_group_adamw(
            ttrain.MPlugTrainConfig(opt=opt), ["params/a.weight"]) is not None
    with pytest.raises(ValueError, match="unsupported opt 'sgdw'"):
        ttrain.make_two_group_adamw(ttrain.MPlugTrainConfig(opt="sgdw"), ())


# ---------------------------------------------------------- the train step

@pytest.mark.parametrize("mode,distill", MODES, ids=IDS)
def test_one_step_from_a_carried_state(sides, mode, distill):
    one_step_from_a_carried_state(sides, mode, distill)


def one_step_from_a_carried_state(sides, mode, distill):
    side = sides(mode, distill)
    tstate = side.port_state(side.jstate)
    side.assert_states_close(side.jstate, tstate, 0.0)
    assert tstate.step == tstate.opt_state.count == 2
    jb, tb = side.batches[2]
    jstate, want = side.jstep(side.jstate, jb)
    tstate, got = side.tstep(tstate, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)
    assert tstate.step == tstate.opt_state.count == int(jstate.step) == 3
    side.assert_states_close(jstate, tstate, 1e-6)


@pytest.mark.parametrize("mode,distill", MODES, ids=IDS)
def test_four_step_trajectory_with_a_reset(sides, mode, distill):
    """Four steps across an epoch boundary; in mask mode the thresholds
    are reset to a moved target after the second (the twins' from their
    own scores)."""
    four_step_trajectory_with_a_reset(sides, mode, distill)


def four_step_trajectory_with_a_reset(sides, mode, distill):
    side = sides(mode, distill)
    jstate = side.jstate
    tstate = side.port_state(jstate)
    for i, (jb, tb) in enumerate(side.batches[2:6]):
        jstate, want = side.jstep(jstate, jb)
        tstate, got = side.tstep(tstate, tb)
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-5, err_msg=f"step {i}")
        if i == 1 and mode == "mask":
            # at 0.4 the fp32 (JAX) and float64 (port) k agree on these
            # matrices; test_torch_vqa_mplug.py pins a target where not
            jstate = side.jreset(jstate, 0.4)
            tstate = side.treset(tstate, 0.4)
            report = side.tmasker.sparsity_report(tstate.scores,
                                                  tstate.thresholds)
            assert abs(report["all"] - 0.4) < 2e-3
    assert tstate.step == int(jstate.step) == 6
    side.assert_states_close(jstate, tstate, 4e-5)


def test_head_param_split_and_merge():
    params = {"text_decoder.cls.predictions.bias": torch.zeros(2),
              "text_decoder.bert.embeddings.word_embeddings.weight":
                  torch.zeros(2),
              "x.classifier.weight": torch.ones(1)}
    head = ttrain.split_head_params(params, ("predictions", "classifier"))
    assert sorted(head) == ["text_decoder.cls.predictions.bias",
                            "x.classifier.weight"]
    assert list(ttrain.split_head_params(params, ("predictions",))) == [
        "text_decoder.cls.predictions.bias"]
    merged = ttrain.merge_head_params(params, {"x.classifier.weight":
                                               torch.full((1,), 2.0)})
    assert float(merged["x.classifier.weight"]) == 2.0
    assert float(params["x.classifier.weight"]) == 1.0
