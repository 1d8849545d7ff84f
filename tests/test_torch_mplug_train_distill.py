"""tests/test_torch_mplug_train.py's train-step checks in the distill
modes (`--distill true`: the momentum twins, their EMA'd scores and
thresholds, the soft labels), in a file of their own so that each file
stays a short job for one test worker: one step from a carried state,
a four-step trajectory with a reset, and the training state's make-up;
that file's `sides` fixture and tolerances.
"""
import dataclasses

import pytest
import torch

from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.train import mplug_train as ttrain
from tests.test_torch_mplug_train import (  # noqa: F401 (a fixture)
    DISTILL_IDS, DISTILL_MODES, _np, four_step_trajectory_with_a_reset,
    one_step_from_a_carried_state, sides)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("mode,distill", DISTILL_MODES, ids=DISTILL_IDS)
def test_one_step_from_a_carried_state(sides, mode, distill):
    one_step_from_a_carried_state(sides, mode, distill)


@pytest.mark.parametrize("mode,distill", DISTILL_MODES, ids=DISTILL_IDS)
def test_four_step_trajectory_with_a_reset(sides, mode, distill):
    """Four steps across an epoch boundary; in mask mode the thresholds
    are reset to a moved target after the second (the twins' from their
    own scores)."""
    four_step_trajectory_with_a_reset(sides, mode, distill)


def test_init_state_for_training(sides):
    """Trained leaves are fp32 masters that require gradients, the rest is
    frozen in the model's dtypes; twins only with distill; the serving
    state carries neither optimizer nor generators."""
    side = sides("mask", True)
    params = convert.mplug_state_dict_from_jax(_np(side.jparams))
    state = ttrain.init_state(side.tmodel, params, side.tcfg, "cpu",
                              side.tmasker, seed=3, train=True)
    leaves = ttrain.trainable(state, side.tcfg)
    trained = {id(t) for t in leaves.values()}
    for t in state.params.values():
        assert t.requires_grad == (id(t) in trained)
    assert all(t.dtype == torch.float32 for t in leaves.values())
    assert state.params_m.keys() == state.params.keys()
    assert state.scores_m.keys() == state.scores.keys()
    assert all(not t.requires_grad for t in state.params_m.values())
    assert set(state.opt_state.mu) == set(leaves)
    serving = ttrain.init_state(side.tmodel, params, dataclasses.replace(
        side.tcfg, distill=False), "cpu", side.tmasker, seed=3)
    assert serving.opt_state is None and serving.rng is None
    assert serving.params_m is None
    for k in state.scores:
        assert torch.equal(serving.scores[k], state.scores[k].detach())
    with pytest.raises(ValueError, match="needs a masker"):
        ttrain.init_state(side.tmodel, params, side.tcfg, "cpu", None)
