"""tests/test_torch_mplug_train.py's activation checkpointing and
AdaHessian checks, in a file of their own so that each file stays a short
job for one test worker: `--use_checkpoint true` against the JAX
package's remat step (that file's `sides` fixture and one-step
tolerances), checkpointed steps bit-identical to plain ones with dropout
on, and one AdaHessian step against the JAX package's.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from crvqa_tpu.cli import vqa_mplug as jcli
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu.train import timm_optim as jtimm
from crvqa_tpu_torch.cli import vqa_mplug as tcli
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.train import mplug_train as ttrain
from tests.test_torch_mplug_train import (  # noqa: F401 (a fixture)
    BATCH, TRAIN_KW, _argv, _batch, _np, sides)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


# ------------------------------------------- checkpointing and AdaHessian

@pytest.mark.parametrize("mode", ["mask"])
def test_checkpointed_step_against_the_jax_remat_step(sides, mode):
    """`--use_checkpoint true` on both sides (the JAX package's `use_remat`,
    flax `nn.remat`): one step from the carried state, the tolerances of
    `test_one_step_from_a_carried_state`."""
    side = sides(mode, False, ("--use_checkpoint", "true"))
    assert side.jconfig.vit.use_remat and side.tconfig.vit.use_checkpoint
    tstate = side.port_state(side.jstate)
    jb, tb = side.batches[2]
    jstate, want = side.jstep(side.jstate, jb)
    tstate, got = side.tstep(tstate, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)
    side.assert_states_close(jstate, tstate, 1e-6)


def _port_run(mode, use_checkpoint, steps=2, rate="0.1"):
    """`steps` port train steps at dropout `rate` from one seed: (losses,
    state)."""
    from crvqa_tpu_torch.data.mplug_data import synthetic_mplug_batch as tb

    args = tcli.build_parser().parse_args([
        "--tiny", "--dtype", "float32", "--output_dir", "unused", "--device",
        "cpu", "--mode", mode, "--seed", "3", "--hidden_dropout_prob", rate,
        "--attention_probs_dropout_prob", rate, "--use_checkpoint",
        str(use_checkpoint)])
    config, _, model = tcli.build_model(args)
    masker = tcli.build_masker(args, config) if mode == "mask" else None
    cfg = tcli.train_config(args, 4)
    state = ttrain.init_state(model, tcli.initial_params(args, config), cfg,
                              "cpu", masker=masker, seed=3, train=True)
    step = ttrain.make_train_step(model, cfg, masker)
    losses = []
    for i in range(steps):
        b = tb(batch_size=BATCH, image_res=32, vocab_size=128, seed=20 + i,
               uint8_images=True)
        batch = {k: torch.from_numpy(v) for k, v in b.items() if k != "qid"}
        for k in ("question_ids", "answer_ids"):
            batch[k] = batch[k].long()
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, state


@pytest.mark.parametrize("mode", ["mask", "full"])
def test_checkpointed_steps_are_bit_identical_with_dropout(mode,
                                                           monkeypatch):
    """Dropout 0.1 everywhere: two checkpointed steps give the plain
    steps' losses, parameters and scores bit for bit, because every
    recompute replays its block's generators. Without the replay (the
    generators left where the forward put them) the recompute draws other
    masks and the gradients change."""
    from crvqa_tpu_torch.models import layers

    want, plain = _port_run(mode, False)
    got, ckpt = _port_run(mode, True)
    assert got == want
    for k in plain.params:
        assert torch.equal(plain.params[k], ckpt.params[k]), k
    if mode == "mask":
        for k in plain.scores:
            assert torch.equal(plain.scores[k], ckpt.scores[k]), k
    monkeypatch.setattr(layers, "_generators", lambda module: [])
    _, drifted = _port_run(mode, True)
    key = ("scores", next(iter(plain.scores))) if mode == "mask" else None
    trained = (plain.scores if mode == "mask" else plain.params)
    moved = (drifted.scores if mode == "mask" else drifted.params)
    assert key is None or key[1] in trained
    assert any(not torch.equal(trained[k], moved[k]) for k in trained)


def test_adahessian_step_equals_jax(tmp_path):
    """One mask-mode AdaHessian step of the tiny mPLUG against the JAX
    package's (`train_step`'s loss, probe, `hutchinson` and update, the
    loss function written out as its own: the masked params, the dropout
    key), the Rademacher probe z drawn as the JAX step draws it and handed
    to the port: the loss, the Hutchinson diagonal
    (both within 1e-5 relative, the diagonal to its largest entry) and
    the updated scores and head (each entry within the diagonal's
    tolerance carried through its update, lr * g / |h|).
    The port's model takes the plain attention (`--opt adahessian`)."""
    argv = _argv(tmp_path, "mask", False, ("--opt", "adahessian"))
    jargs = jcli.build_parser().parse_args(argv)
    jconfig, _, jmodel = jcli.build_model(jargs)
    jmasker = jcli.build_masker(jargs, jconfig)[0]
    targs = tcli.build_parser().parse_args(argv + ["--device", "cpu"])
    tconfig, _, tmodel = tcli.build_model(targs)
    assert not tconfig.bert.attention_kernels
    assert not tconfig.vit.attention_kernels
    tmasker = tcli.build_masker(targs, tconfig)
    kw = dict(mode="mask", opt="adahessian", **TRAIN_KW)
    jcfg, tcfg = jtrain.MPlugTrainConfig(**kw), ttrain.MPlugTrainConfig(**kw)
    jb, tb = _batch(4, 128)
    rng = jax.random.PRNGKey(3)
    jparams = jax.jit(jmodel.init)(
        rng, jb["images"], jb["question_ids"], jb["question_mask"],
        jb["answer_ids"], jb["answer_mask"], jb["weights"])["params"]
    jstate, tx = jtrain.init_state(jmodel, jparams, jcfg, rng,
                                   masker=jmasker)
    # the probe and the dropout key of the JAX train_step (its first lines)
    key, dropout_rng = jax.random.split(jstate.rng)
    _, hess_rng = jax.random.split(key)
    trainable = {"scores": jstate.scores,
                 "head": jtrain.split_head_params(jstate.params,
                                                  jcfg.head_substrings)}

    def jloss(t):
        params = jmasker.apply_masks(
            jtrain.merge_head_params(jstate.params, t["head"]), t["scores"],
            jstate.thresholds)
        return jmodel.apply({"params": params}, jb["images"],
                            jb["question_ids"], jb["question_mask"],
                            jb["answer_ids"], jb["answer_mask"],
                            jb["weights"], bias=jb["bias"],
                            deterministic=False,
                            rngs={"dropout": dropout_rng})

    jl, jgrads, jhess = jax.jit(
        lambda t, r: jtimm.hutchinson(jloss, t, r))(trainable, hess_rng)
    jz = jtimm.rademacher_like(hess_rng, trainable)
    # the train step's own update from this (grads, hess) pair
    upd, _ = tx.update((jgrads, jhess), jstate.opt_state, trainable)
    jnew = jstate.replace(scores=optax.apply_updates(
        trainable, upd)["scores"], params=jtrain.merge_head_params(
            jstate.params, optax.apply_updates(trainable, upd)["head"]))

    tstate = ttrain.init_state(
        tmodel, convert.mplug_state_dict_from_jax(_np(jparams)), tcfg, "cpu",
        tmasker, seed=3, train=True)
    z = {k: torch.from_numpy(np.array(v)) for k, v in
         _port_arrays(jz, tmasker).items()}
    loss, grads, hess = ttrain.make_loss_and_grads(tmodel, tcfg, tmasker)(
        tstate, tb, z=z)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want_h = _port_arrays(jhess, tmasker)
    assert set(want_h) == set(hess)
    top = max(np.abs(h).max() for h in want_h.values())
    assert top > 0
    for k, h in want_h.items():
        np.testing.assert_allclose(hess[k].numpy(), h, rtol=0,
                                   atol=1e-5 * top, err_msg=k)
    leaves = ttrain.trainable(tstate, tcfg)
    before = {k: v.detach().clone() for k, v in leaves.items()}
    opt = ttrain.make_two_group_adamw(tcfg, leaves)
    opt.step(leaves, (grads, hess), tstate.opt_state)
    want = _port_arrays({"scores": _np(jnew.scores),
                         "head": jtrain.split_head_params(
                             _np(jnew.params), jcfg.head_substrings)},
                        tmasker)
    assert set(want) == set(leaves)
    change = max(np.abs(want[k] - before[k].numpy()).max() for k in want)
    assert change > 0
    for k, t in want.items():
        # an entry moves by about lr * g / |h|: the diagonal's tolerance
        # (1e-5 of its largest entry) grows by |u| / |h| in the update
        u = t - before[k].numpy()
        h = np.abs(want_h[k])
        bound = (2 * np.abs(u) * 1e-5 * top / np.maximum(h, 1e-30)
                 + 1e-6 * change)
        diff = np.abs(leaves[k].detach().numpy() - t)
        assert (diff <= bound).all(), (k, diff.max())


def _port_arrays(tree, masker):
    """{port trainable name: numpy array in the port's layout} of a JAX
    trainable tree (mask mode)."""
    out = {}
    scores, _ = convert.mask_state_from_jax(
        {k: np.asarray(v) for k, v in tree["scores"].items()}, {},
        masker.specs)
    for k, t in scores.items():
        out[f"scores/{k}"] = t.numpy()
    for k, v in tree["head"].items():
        name, arr = convert.mplug_torch_name(tuple(k.split("/")),
                                             np.asarray(v))
        out[f"head/{name}"] = np.asarray(arr)
    return out
