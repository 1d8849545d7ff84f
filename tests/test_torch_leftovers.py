"""The port's `FCNet` and `GTH` heads (crvqa_tpu_torch/models/classifier.py)
and its metric logger (crvqa_tpu_torch/utils/metric_logger.py) against the
JAX package's.

- FCNet (three dims, each activation) and GTH in fp32 on the JAX params
  loaded by `state_dict_from_jax` with `strict=True`: outputs within atol
  1e-6 (the same products, summed in another order).
- SmoothedValue and MetricLogger fed the same values: every statistic
  equal (float arithmetic in the same order on both sides) and the same
  strings; `log_every` yields the same items and prints the same lines
  apart from the times.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.models.classifier import FCNet as JaxFCNet
from crvqa_tpu.models.classifier import GTH as JaxGTH
from crvqa_tpu.utils import metric_logger as jml
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.models import FCNet, GTH
from crvqa_tpu_torch.utils import metric_logger as tml


def _port(module, params, x):
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                            params)),
                           strict=True)
    module.eval()
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("act", ["ReLU", "Sigmoid", "Tanh"])
def test_fcnet_matches_jax(act):
    dims = (12, 20, 7)
    x = np.random.default_rng(0).normal(size=(5, dims[0])).astype(np.float32)
    jmodel = JaxFCNet(dims, 0.3, act)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = _port(FCNet(dims, 0.3, act), params, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_gth_matches_jax():
    x = np.random.default_rng(2).normal(size=(4, 3, 16)).astype(np.float32)
    jmodel = JaxGTH(16, 9, 0.1)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = GTH(16, 9, 0.1)
    assert sorted(k for k, _ in model.named_parameters()) == sorted(
        state_dict_from_jax(jax.tree.map(np.asarray, params)))
    got = _port(model, params, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


VALUES = [3.5, -1.25, 7.0, 0.5, 2.0, 2.0, 9.75, -4.0, 1.0]


@pytest.mark.parametrize("window", [1, 4, 6, 20])
def test_smoothed_value_equals_jax(window):
    fmt = "{median:.4f} {avg:.4f} {global_avg:.4f} {value:.4f}"
    ours, theirs = (m.SmoothedValue(window, fmt) for m in (tml, jml))
    for i, v in enumerate(VALUES):
        n = 1 + i % 3
        ours.update(v, n)
        theirs.update(v, n)
        for stat in ("median", "max", "avg", "global_avg", "value"):
            assert getattr(ours, stat) == getattr(theirs, stat), (stat, i)
        assert str(ours) == str(theirs)
    empty = tml.SmoothedValue()
    assert (empty.median, empty.max, empty.avg, empty.global_avg,
            empty.value) == (0.0, 0.0, 0.0, 0.0, 0.0)


def test_metric_logger_equals_jax(capsys):
    ours, theirs = tml.MetricLogger(" | "), jml.MetricLogger(" | ")
    for i, v in enumerate(VALUES):
        for logger in (ours, theirs):
            logger.update(loss=v, lr=torch.tensor(1e-3 * (i + 1)).item(),
                          acc=np.float32(v / 10))
    ours.synchronize_between_processes()
    assert str(ours) == str(theirs)
    assert list(ours.meters) == ["loss", "lr", "acc"]
    printed = []
    for logger in (ours, theirs):
        items = list(logger.log_every(range(7), 3, header="Train:"))
        assert items == list(range(7))
        # the times differ from run to run
        printed.append(re.sub(r"\d+\.\d+s|time: \d+\.\d+", "T",
                              capsys.readouterr().out))
    assert printed[0] == printed[1]
    assert printed[0].count("\n") == 4  # items 0, 3, 6 and the total
