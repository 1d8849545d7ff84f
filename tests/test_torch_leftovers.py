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
- The small public helpers: `core.checkpoint.load_metadata` and
  `latest_checkpoint` over the port's `ckpt_<step>` files and their
  `.meta.json` (equal results), `models.mplug.interpolate_pos_embed`
  (fp32, within atol 2e-6: the same bicubic taps, summed in another
  order), `masking.compaction.expand_head_mask_dense` (the transpose of
  the JAX [in, out] mask, exactly) and `masking.spec.specs_by_modality`
  (the same groups of the same specs, in the same order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.masking import compaction as jcompaction
from crvqa_tpu.masking import spec as jspec
from crvqa_tpu.models.classifier import FCNet as JaxFCNet
from crvqa_tpu.models.classifier import GTH as JaxGTH
from crvqa_tpu.models.mplug import interpolate_pos_embed as jinterpolate
from crvqa_tpu.utils import metric_logger as jml
from crvqa_tpu_torch.core import checkpoint as tckpt
from crvqa_tpu_torch.core.convert import state_dict_from_jax
from crvqa_tpu_torch.masking import compaction as tcompaction
from crvqa_tpu_torch.masking import spec as tspec
from crvqa_tpu_torch.models import FCNet, GTH
from crvqa_tpu_torch.models.mplug import interpolate_pos_embed
from crvqa_tpu_torch.utils import metric_logger as tml
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


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


def _checkpoints(tmp_path):
    """A run's directory: the port's ckpt_<step> files with metadata, and
    names neither package takes for a checkpoint."""
    for step in (3, 12, 7):
        tckpt.save_msgpack(str(tmp_path / f"ckpt_{step}"),
                           {"w": np.full(2, step, np.float32)},
                           metadata={"step": step})
    for name in ("ckpt_40.tmp", "ckpt_x", "best_99", "ckpt_"):
        (tmp_path / name).write_bytes(b"")
    return tmp_path


def _helper_load_metadata(tmp_path):
    root = _checkpoints(tmp_path)
    for name in ("ckpt_3", "ckpt_12", "ckpt_x"):
        got = tckpt.load_metadata(str(root / name))
        assert got == jckpt.load_metadata(str(root / name))
    assert tckpt.load_metadata(str(root / "ckpt_12")) == {"step": 12}
    assert tckpt.load_metadata(str(root / "ckpt_x")) is None


def _helper_latest_checkpoint(tmp_path):
    root = _checkpoints(tmp_path)
    for d in (root, tmp_path / "missing", tmp_path / "empty"):
        assert (tckpt.latest_checkpoint(str(d))
                == jckpt.latest_checkpoint(str(d)))
    assert tckpt.latest_checkpoint(str(root)) == str(root / "ckpt_12")
    (tmp_path / "empty").mkdir()
    assert tckpt.latest_checkpoint(str(tmp_path / "empty")) is None
    assert (tckpt.latest_checkpoint(str(root), prefix="best_")
            == jckpt.latest_checkpoint(str(root), prefix="best_")
            == str(root / "best_99"))


def _helper_interpolate_pos_embed(tmp_path):
    rng = np.random.default_rng(4)
    for old, new in ((24, 14), (14, 24), (7, 3), (5, 5)):
        pos = rng.normal(size=(1 + old * old, 16)).astype(np.float32)
        want = np.asarray(jinterpolate(jnp.asarray(pos), new * new))
        got = interpolate_pos_embed(torch.from_numpy(pos), new * new)
        assert got.shape == want.shape == (1 + new * new, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(got[0].numpy(), pos[0])


def _helper_expand_head_mask_dense(tmp_path):
    for row in ([1, 0, 1, 1], [0, 0], [True, False, True]):
        want = jcompaction.expand_head_mask_dense(np.asarray(row), 3, 5)
        got = tcompaction.expand_head_mask_dense(np.asarray(row), 3, 5)
        assert got.shape == (3 * len(row), 5)
        np.testing.assert_array_equal(got, want.T)


def _helper_specs_by_modality(tmp_path):
    for jspecs, tspecs in (
            (jspec.lxmert_mask_specs(2, 1, 1),
             tspec.lxmert_mask_specs(2, 1, 1)),
            (jspec.visualbert_mask_specs(2),
             tspec.visualbert_mask_specs(2))):
        want = jspec.specs_by_modality(jspecs)
        got = tspec.specs_by_modality(tspecs)
        assert list(got) == list(want)
        for modality, specs in got.items():
            assert [s.path for s in specs] == [
                s.path for s in want[modality]]
            assert all(s.modality == modality for s in specs)


HELPERS = {name[len("_helper_"):]: fn for name, fn in globals().items()
           if name.startswith("_helper_")}


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_public_helper_matches_jax(helper, tmp_path):
    HELPERS[helper](tmp_path)
