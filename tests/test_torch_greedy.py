"""Greedy decoding of the port (`models/mplug/generator.greedy_generate`)
against the JAX package's `greedy_generate` on `MPlugConfig.tiny()` in
fp32, with the JAX weights carried into the port
(tests/test_torch_mplug_generate.py's `_sides`, `--mode full`): the same
token ids in each of its three modes (full logits, the LM head sliced to
the decode position, incremental decoding with self-attention KV caches),
with the model's own eos, and in the cached mode (a server's) also with
an eos the model emits early (taken from the JAX ids), so that rows stop
and pad as in JAX. Each JAX decode is compiled once per (mode, eos).
"""
import jax
import numpy as np
import pytest
import torch

from crvqa_tpu.models.mplug.generator import greedy_generate as jgreedy
from crvqa_tpu.models.mplug.generator import init_self_caches as jcaches
from crvqa_tpu_torch.models.mplug.generator import (greedy_generate,
                                                    init_self_caches)
from crvqa_tpu_torch.train.mplug_train import run_masked
from tests.test_torch_mplug_generate import _sides
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

MAX_LEN = 6


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return _sides(tmp_path_factory.mktemp("greedy"), "full")


@pytest.fixture(scope="module")
def jax_ids(sides):
    """(mode, eos) -> the JAX package's ids, each decode compiled once."""
    cache = {}

    def get(mode, eos):
        if (mode, eos) not in cache:
            cache[(mode, eos)] = _jax_ids(sides[0], mode, eos)
        return cache[(mode, eos)]

    return get


def _jax_ids(side, mode, eos):
    _, config, model, _, state, jb = side
    c = config.bert
    params = {"params": state.params}
    states, state_mask = model.apply(params, jb["images"], jb["question_ids"],
                                     jb["question_mask"], method=model.encode)

    def full(ids, mask, st, st_mask):
        return model.apply(params, ids, mask, st, st_mask,
                           method=model.decode_logits)

    def sliced(ids, mask, st, st_mask, position=None):
        return model.apply(params, ids, mask, st, st_mask, position=position,
                           method=model.decode_logits)

    def step(ids, st, st_mask, position, caches):
        return model.apply(params, ids, st, st_mask, position, caches,
                           method=model.decode_logits_step)

    kw = dict(max_len=MAX_LEN, bos=config.bos_token_id, eos=eos,
              pad=config.pad_token_id)
    if mode == "cached":
        kw.update(decode_step=step, init_caches=jcaches(
            states.shape[0], c.text_decode_layers, MAX_LEN,
            c.num_attention_heads, c.head_size))
    return np.asarray(jax.jit(lambda s, m: jgreedy(
        sliced if mode == "sliced" else full, s, m, **kw))(states,
                                                          state_mask))


def _port_ids(side, mode, eos):
    _, config, model, _, state, tb = side
    c = config.bert

    def run(m, images, question_ids, question_mask):
        states, state_mask = m.encode(images, question_ids, question_mask)

        def full(ids, mask, st, st_mask):
            return m.decode_logits(ids, mask, st, st_mask)

        def sliced(ids, mask, st, st_mask, position=None):
            return m.decode_logits(ids, mask, st, st_mask, position=position)

        def step(ids, st, st_mask, position, caches):
            return m.decode_logits_step(ids, st, st_mask, position, caches)

        kw = dict(max_len=MAX_LEN, bos=config.bos_token_id, eos=eos,
                  pad=config.pad_token_id)
        if mode == "cached":
            kw.update(decode_step=step, init_caches=init_self_caches(
                states.shape[0], c.text_decode_layers, MAX_LEN,
                c.num_attention_heads, c.head_size))
        return greedy_generate(sliced if mode == "sliced" else full, states,
                               state_mask, **kw)

    return run_masked(model, None, state, run, tb["images"],
                      tb["question_ids"], tb["question_mask"]).numpy()


@pytest.mark.parametrize("mode,early_eos", [
    ("full", False), ("sliced", False), ("cached", False), ("cached", True)])
def test_greedy_ids_equal_jax(sides, jax_ids, mode, early_eos):
    jside, tside = sides
    config = jside[1]
    eos = config.eos_token_id
    if early_eos:  # a token the model emits at step 2 of row 0
        eos = int(jax_ids("full", eos)[0, 2])
    want = jax_ids(mode, eos)
    got = _port_ids(tside, mode, eos)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (want.shape[0], MAX_LEN)
    assert (got[:, 0] == config.bos_token_id).all()
    for row in got:  # after eos, pad only
        hit = np.flatnonzero(row[1:] == eos)
        if hit.size:
            assert (row[hit[0] + 2:] == config.pad_token_id).all()
    if early_eos:
        assert got[0, 2] == eos and (got[0, 3:] == config.pad_token_id).all()
