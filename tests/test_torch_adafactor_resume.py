"""A JAX mPLUG training state under `--opt adafactor` with square factored
leaves, carried into the port (`core/convert.mplug_state_from_jax`) and
back (`jax_from_mplug_state`).

optax factors a leaf's second moment over its two largest dims when the
smaller is 128 or more. A square leaf ties, and both packages break the
tie alike (rows over dim 0, columns over dim 1), so on a kernel or a score
that the port stores [out, in] where the JAX package stores [in, out] the
port's v_row is the JAX v_col and the reverse: the carry swaps them by the
leaf's layout.

Setup: the tiny mPLUG widened to 128 (BERT hidden and ViT width, FFN 256,
so every attention projection and its mask score is a square factored
leaf), fp32, every dropout 0, `--mode mask` (the CLI's default: its
trainables hold both layouts' square leaves, mask scores and the LM
head's 128 x 128 transform kernel), two JAX steps. Checks: the carried state written back in the JAX layout equals
the JAX state bit for bit, and as a file byte for byte; one more step on
each side agrees at tests/test_torch_mplug_train.py's one-step tolerances
(loss atol 1e-5, parameters and scores atol 1e-6), and every optimizer
leaf after it (the factored v_row / v_col included) within rtol 1e-4 of
the JAX state's (fp32 sums of squared gradients in another order) and
atol 1e-6 of its slot's largest value (rounding noise where a gradient is
0 in exact arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.cli import vqa_mplug as jcli
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.data.mplug_data import synthetic_mplug_batch
from crvqa_tpu.models.mplug import mplug as jmplug
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.cli import vqa_mplug as tcli
from crvqa_tpu_torch.core import checkpoint as ckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.train import mplug_train as ttrain
from tests.test_torch_resume_interchange import _array, assert_bit_equal, flat
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

WIDTH = 128
TRAIN_KW = dict(steps_per_epoch=2, epochs=2, warmup_epochs=1, total_steps=4,
                warmup_steps=2, opt="adafactor")


def _argv(tmp, mode):
    return ["--tiny", "--dtype", "float32", "--output_dir", str(tmp),
            "--mode", mode, "--seed", "3", "--opt", "adafactor",
            "--hidden_dropout_prob", "0", "--attention_probs_dropout_prob",
            "0", "--init_sparsity", "0.3"]


def _wide(config):
    return dataclasses.replace(
        config, bert=dataclasses.replace(config.bert, hidden_size=WIDTH,
                                         intermediate_size=2 * WIDTH),
        vit=dataclasses.replace(config.vit, width=WIDTH))


def _batch(seed, vocab):
    b = synthetic_mplug_batch(batch_size=3, image_res=32, vocab_size=vocab,
                              seed=seed, uint8_images=True)
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "qid"}
    tb = {k: torch.from_numpy(v) for k, v in b.items() if k != "qid"}
    for k in ("question_ids", "answer_ids"):
        tb[k] = tb[k].long()
    return jb, tb


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    mode = "mask"
    tmp = tmp_path_factory.mktemp(f"adafactor_{mode}")
    jargs = jcli.build_parser().parse_args(_argv(tmp, mode))
    jconfig = _wide(jcli.build_model(jargs)[0])
    jmodel = jmplug.MPlug(jconfig)
    jmasker = (jcli.build_masker(jargs, jconfig)[0] if mode == "mask"
               else None)
    vocab = jconfig.bert.vocab_size
    batches = [_batch(s, vocab) for s in (4, 5, 6)]
    jb = batches[0][0]
    rng = jax.random.PRNGKey(3)
    jparams = jax.jit(jmodel.init)(
        rng, jb["images"], jb["question_ids"], jb["question_mask"],
        jb["answer_ids"], jb["answer_mask"], jb["weights"])["params"]
    jcfg = jtrain.MPlugTrainConfig(mode=mode, **TRAIN_KW)
    jstate, tx = jtrain.init_state(jmodel, jparams, jcfg, rng,
                                   masker=jmasker)
    jstep = jax.jit(jtrain.make_train_step(jmodel, jcfg, tx,
                                           masker=jmasker).__wrapped__)
    for b, _ in batches[:2]:
        jstate, _ = jstep(jstate, b)
    path = str(tmp / "ckpt_2")
    jckpt.save_checkpoint(path, jstate)

    targs = tcli.build_parser().parse_args(_argv(tmp, mode)
                                           + ["--device", "cpu"])
    tconfig = _wide(tcli.build_model(targs)[0])
    tmodel = ttrain.mplug_meta_model(tconfig)
    tmasker = tcli.build_masker(targs, tconfig) if mode == "mask" else None
    tcfg = ttrain.MPlugTrainConfig(mode=mode, **TRAIN_KW)
    state = ttrain.init_state(
        tmodel, convert.mplug_state_dict_from_jax(
            jax.tree.map(np.asarray, jparams)),
        tcfg, "cpu", tmasker, seed=3, train=True)
    specs = tmasker.specs if tmasker else None
    convert.mplug_state_from_jax(state, ckpt.load_jax_training_state(path),
                                 tcfg, specs)
    return dict(mode=mode, tmp=tmp, path=path, jstate=jstate, jstep=jstep,
                batches=batches, state=state, tmodel=tmodel, tcfg=tcfg,
                tmasker=tmasker, specs=specs)


def _square_factored(state):
    slots = state.opt_state.slots
    return [k for k, v in slots["v_row"].items()
            if v.shape == slots["v_col"][k].shape]


def test_square_leaves_are_factored(sides):
    """The widened model has square factored leaves (the case this file
    is about) of both kinds the layouts transpose, a score and a kernel,
    their factors carried across nonzero."""
    square = _square_factored(sides["state"])
    assert len(square) >= 10
    assert any(k.startswith("scores/") and "query" in k for k in square)
    assert any(k.startswith("head/") for k in square)
    assert all(float(sides["state"].opt_state.slots["v_row"][k].min()) > 0
               for k in square)


def test_written_back_equal_to_the_jax_state(sides):
    s = sides
    tree = convert.jax_from_mplug_state(s["state"], s["tmodel"], s["tcfg"],
                                        s["specs"])
    assert_bit_equal(tree, ckpt.load_jax_training_state(s["path"]))
    again = str(s["tmp"] / "port_ckpt_2")
    ckpt.save_jax_training_state(again, tree)
    with open(s["path"], "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_one_step_after_the_carry_equals_jax(sides):
    s = sides
    jb, tb = s["batches"][2]
    jstate, want = s["jstep"](s["jstate"], jb)
    state = s["state"]
    step = ttrain.make_train_step(s["tmodel"], s["tcfg"], s["tmasker"])
    state, got = step(state, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)
    path = str(s["tmp"] / "jax_ckpt_3")
    jckpt.save_checkpoint(path, jstate)
    want_tree = flat(ckpt.load_jax_training_state(path))
    got_tree = flat(convert.jax_from_mplug_state(state, s["tmodel"],
                                                 s["tcfg"], s["specs"]))
    assert set(got_tree) == set(want_tree)
    leaves = {k: _array(w) for k, w in want_tree.items()
              if not (k == "/rng" or w is None or isinstance(w, dict))}

    def slot(k):  # the optimizer slot a leaf belongs to
        return next((s for s in ("/v_row/", "/v_col/", "/v/") if s in k), k)

    scale = {}
    for k, b in leaves.items():
        scale[slot(k)] = max(scale.get(slot(k), 0.0), float(np.abs(b).max()))
    factors = 0
    for k, b in leaves.items():
        a = _array(got_tree[k])
        if k.startswith("/opt_state"):
            factors += "/v_row/" in k and b.size > 1
            # a gradient 0 in exact arithmetic (a key bias under softmax)
            # leaves rounding noise of about 1e-22 on both sides: atol
            # 1e-6 of the slot's largest value
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-6 * scale[slot(k)],
                                       err_msg=k)
        elif k.startswith(("/params", "/scores", "/thresholds")):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(a, b), k
    assert factors >= 10
