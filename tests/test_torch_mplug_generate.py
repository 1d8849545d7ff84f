"""Beam search and answer ranking of the port (crvqa_tpu_torch/train/
mplug_train.py, cli/vqa_mplug.py) vs the JAX package's `make_generate_step`
and `build_rank_fn` on `MPlugConfig.tiny()`, in `--mode mask` and `--mode
full`: both sides are built by their CLIs' own build functions from one
argv, and the JAX weights, mask scores and thresholds are carried into
the port.

The generated token ids and the ranked answer ids must be equal; scores,
probabilities and LM losses agree within atol 1e-5 (fp32 on both sides).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crvqa_tpu.cli import vqa_mplug as jcli
from crvqa_tpu.data.mplug_data import synthetic_mplug_batch
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.cli import vqa_mplug as tcli
from crvqa_tpu_torch.core.convert import (mask_state_from_jax,
                                          mplug_state_dict_from_jax)
from crvqa_tpu_torch.train import mplug_train as ttrain
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

BATCH = 3


def _argv(tmp, mode, extra=()):
    return ["--tiny", "--dtype", "float32", "--output_dir", str(tmp),
            "--mode", mode, "--beam_size", "3", "--max_answer_len", "6",
            "--seed", "3", *extra]


def _sides(tmp, mode, extra=()):
    """(jax side, port side), each (args, config, model, masker, state,
    batch), from one argv and one set of JAX weights."""
    jargs = jcli.build_parser().parse_args(_argv(tmp, mode, extra))
    jconfig, _, jmodel = jcli.build_model(jargs)
    jmasker = jcli.build_masker(jargs, jconfig)[0] if mode == "mask" else None
    b0 = synthetic_mplug_batch(batch_size=BATCH, image_res=32,
                               vocab_size=jconfig.bert.vocab_size, seed=4,
                               uint8_images=True)
    jb = {k: jnp.asarray(v) for k, v in b0.items() if k != "qid"}
    rng = jax.random.PRNGKey(jargs.seed)
    params = jax.jit(jmodel.init)(
        rng, jb["images"], jb["question_ids"], jb["question_mask"],
        jb["answer_ids"], jb["answer_mask"], jb["weights"])["params"]
    scores = thresholds = None
    if jmasker is not None:
        scores, thresholds = jmasker.init(params, rng)
    jstate = jtrain.MPlugState(step=jnp.zeros((), jnp.int32), params=params,
                               scores=scores, thresholds=thresholds,
                               params_m=None, opt_state=None, rng=rng)

    targs = tcli.build_parser().parse_args(
        _argv(tmp, mode, extra) + ["--device", "cpu"])
    tconfig, _, tmodel = tcli.build_model(targs)
    tmasker = tcli.build_masker(targs, tconfig) if mode == "mask" else None
    tparams = mplug_state_dict_from_jax(jax.tree.map(np.asarray, params))
    tstate = ttrain.MPlugState(params=tparams)
    if tmasker is not None:
        tstate.scores, tstate.thresholds = mask_state_from_jax(
            jax.tree.map(np.asarray, scores),
            jax.tree.map(np.asarray, thresholds), tmasker.specs)
    tb = {"images": torch.from_numpy(b0["images"]),
          "question_ids": torch.from_numpy(b0["question_ids"]).long(),
          "question_mask": torch.from_numpy(b0["question_mask"])}
    return ((jargs, jconfig, jmodel, jmasker, jstate, jb),
            (targs, tconfig, tmodel, tmasker, tstate, tb))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """mode -> both sides, built once per module."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _sides(tmp_path_factory.mktemp(mode), mode)
        return cache[mode]

    return get


def test_masker_init_equals_carried_scores(built):
    """The port's own `init_state` (magnitude_soft: scores |w|, thresholds
    the per-matrix k-th value at zero rate 0.5) gives the scores and
    thresholds the JAX masker gave."""
    _, (targs, tconfig, tmodel, tmasker, tstate, _) = built("mask")
    cfg = ttrain.MPlugTrainConfig(mode="mask")
    own = ttrain.init_state(tmodel, tstate.params, cfg, "cpu", tmasker)
    assert own.scores.keys() == tstate.scores.keys()
    for key in own.scores:
        assert torch.equal(own.scores[key], tstate.scores[key]), key
        assert torch.equal(own.thresholds[key], tstate.thresholds[key]), key


@pytest.mark.parametrize("mode,cache,beam", [
    ("mask", True, 3), ("mask", False, 3), ("full", True, 3),
    ("full", False, 3), ("mask", True, 1)])
def test_beam_generate_equals_jax(built, mode, cache, beam):
    """Beam search with and without the self-attention KV caches; beam 1
    keeps a single hypothesis per item, so every cache reorder is the
    identity."""
    (jargs, _, jmodel, jmasker, jstate, jb), \
        (targs, _, tmodel, tmasker, tstate, tb) = built(mode)
    kw = dict(beam_size=beam, max_len=6, use_cache=cache)
    cfg = jtrain.MPlugTrainConfig(mode=jargs.mode)
    want_ids, want_scores = jtrain.make_generate_step(
        jmodel, cfg, masker=jmasker, **kw)(jstate, jb)
    gen = ttrain.make_generate_step(
        tmodel, ttrain.MPlugTrainConfig(mode=targs.mode), masker=tmasker,
        **kw)
    got_ids, got_scores = gen(tstate, tb)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["mask", "full"])
@pytest.mark.parametrize("k_test", [3, 0])
def test_rank_equals_jax(built, mode, k_test):
    """`--k_test 3` (first-token shortlist of the 8-answer synthetic list,
    then the chain-rule re-rank) and `--k_test 0` (the LM loss of every
    answer)."""
    (jargs, jconfig, jmodel, jmasker, jstate, jb), \
        (targs, tconfig, tmodel, tmasker, tstate, tb) = built(mode)
    jargs.k_test = targs.k_test = k_test
    cfg = jtrain.MPlugTrainConfig(mode=jargs.mode)
    jfn, janswers, jbest = jcli.build_rank_fn(jargs, jconfig, None, jmodel,
                                              jmasker, cfg)
    tfn, tanswers, tbest = tcli.build_rank_fn(
        targs, tconfig, None, tmodel, tmasker,
        ttrain.MPlugTrainConfig(mode=targs.mode), "cpu")
    assert tanswers == janswers
    want = jfn(jstate, jb)
    got = tfn(tstate, tb)
    if k_test:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(tbest(got), jbest(want))
