"""Resume in the port from the JAX package's stage-1 and stage-3 training
states (`core/convert.stage1_state_from_jax` / `jax_from_stage1_state`),
on the tiny LXMERT at fp32 with every dropout at 0, as
tests/test_torch_resume_interchange.py does for stage 2: stage 1 with the
LMH loss (optax.adam's state), stage 3 with `--training_type FT_randMask`
(its bool masks by spec key) and `--moment_dtype bfloat16` (the
`torch_adam` state, bf16 moments kept bf16).

- Resumed from the JAX `ckpt_2`, before any step the port's state
  written back in the JAX layout equals the file bit for bit.
- Its `ckpt_4`, two steps on, is held to the JAX run's `ckpt_4`: the
  step-4 loss rtol 1e-4; parameters atol 2 * lr * steps; the moments
  within 1e-3 of their moment's largest value (`moment_scale`; bf16
  moments within 1e-2: one bf16 rounding of nearly the same fp32 value
  may land one ulp apart); masks and counts exact.
- The port's JAX-layout stage-1 file loads in the JAX package's
  `load_checkpoint` into its CLI's state template with the JAX file's
  leaves.
"""
import json

import jax
import numpy as np
import pytest

from crvqa_tpu.cli import run_vqa_stage1 as jstage1_cli
from crvqa_tpu.cli import run_vqa_stage3 as jstage3_cli
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.train import stage1 as jstage1
from crvqa_tpu_torch.cli import common, run_vqa_stage1, run_vqa_stage3
from crvqa_tpu_torch.core import checkpoint as ckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.models import LxmertConfig
from crvqa_tpu_torch.train import stage1, stage2
from tests.test_torch_resume_interchange import (DROPOUT_0, _array,
                                                 assert_bit_equal, flat,
                                                 moment_scale)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

LR = 1e-3
ARGV = ["--tiny", "--dtype", "float32", "--seed", "0", "--synthetic", "16",
        "--synthetic_pool", "2", "--train_batch_size", "8",
        "--eval_batch_size", "8", "--num_train_epochs", "2",
        "--logging_steps", "2", "--save_steps", "2", "--learning_rate",
        str(LR), "--warmup_steps", "0", "--FT_type", "lmh",
        "--do_train"] + DROPOUT_0
KINDS = {
    "stage1": (jstage1_cli, run_vqa_stage1, []),
    "stage3": (jstage3_cli, run_vqa_stage3,
               ["--training_type", "FT_randMask", "--moment_dtype",
                "bfloat16"]),
}


def _config(kind):
    narrow = kind == "stage3"
    return stage1.Stage1Config(moment_dtype="bfloat16" if narrow
                               else "float32")


def _specs(kind):
    if kind == "stage1":
        return ()
    return common.lxmert_uniform_masker(LxmertConfig.tiny(), 0.7).specs


def _model():
    return stage2.lxmert_meta_model(LxmertConfig.tiny())


@pytest.fixture(scope="module", params=sorted(KINDS))
def run(request, tmp_path_factory):
    kind = request.param
    jcli, _, extra = KINDS[kind]
    root = tmp_path_factory.mktemp(kind)
    jcli.main(["--output_dir", str(root / "jax")] + ARGV + extra)
    return kind, root, extra


def _port(kind, root, extra, name, more):
    return KINDS[kind][1].main(
        ["--output_dir", str(root / name), "--device", "cpu",
         "--resume_from", str(root / "jax" / "ckpt_2")]
        + [a for a in ARGV if a != "--do_train"] + extra + more)


def test_resume_is_bit_equal_at_load(run):
    kind, root, extra = run
    state = _port(kind, root, extra, "load", [])["state"]
    assert state.step == 2 and state.opt_state.count == 2
    assert (state.masks is None) == (kind == "stage1")
    tree = convert.jax_from_stage1_state(state, _model(), _config(kind),
                                         _specs(kind))
    assert_bit_equal(tree, ckpt.load_jax_training_state(
        str(root / "jax" / "ckpt_2")))


def test_two_steps_match_the_jax_continuation(run):
    kind, root, extra = run
    summary = _port(kind, root, extra, "cont", ["--do_train"])
    state = summary["state"]
    ckpt.load_stage1_checkpoint(str(root / "cont" / "ckpt_4"), state)
    got = flat(convert.jax_from_stage1_state(state, _model(), _config(kind),
                                             _specs(kind)))
    want = flat(ckpt.load_jax_training_state(str(root / "jax" / "ckpt_4")))
    start = flat(ckpt.load_jax_training_state(str(root / "jax" / "ckpt_2")))
    assert set(got) == set(want)
    jloss = [m["loss"] for m in map(json.loads,
                                    open(root / "jax" / "metrics.jsonl"))
             if m.get("step") == 4 and "loss" in m]
    np.testing.assert_allclose(summary["losses"][1], jloss[0], rtol=1e-4)
    moved = 0
    for k, w in want.items():
        if k == "/rng" or w is None or isinstance(w, dict):
            continue
        a, b = _array(got[k]), _array(w)
        if "/mu/" in k or "/nu/" in k:
            rel = 1e-2 if kind == "stage3" else 1e-3
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=rel * moment_scale(want, k),
                                       err_msg=k)
        elif k.endswith("count") or k == "/step":
            assert int(a) == int(b) == 4, k
        elif b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * 2,
                                       err_msg=k)
            moved += not np.array_equal(b, _array(start[k]))
    assert moved > 0


@pytest.mark.parametrize("run", ["stage1"], indirect=True)
def test_port_written_state_loads_in_the_jax_package(run, tmp_path):
    kind, root, extra = run
    state = _port(kind, root, extra, "write", [])["state"]
    path = tmp_path / "ckpt_2"
    ckpt.save_jax_training_state(str(path), convert.jax_from_stage1_state(
        state, _model(), _config(kind)))
    cfg = JaxConfig.tiny()
    params = jax.jit(JaxLxmert(cfg).init)(
        jax.random.PRNGKey(0), input_ids=np.ones((2, 14), np.int32),
        visual_feats=np.zeros((2, 8, cfg.visual_feat_dim), np.float32),
        visual_pos=np.zeros((2, 8, cfg.visual_pos_dim), np.float32)
    )["params"]
    template, _ = jstage1.init_state(
        params, jstage1.Stage1Config(ft_type="lmh",
                                     hidden_size=cfg.hidden_size),
        jax.random.PRNGKey(1))
    mine = jckpt.load_checkpoint(str(path), template)
    theirs = jckpt.load_checkpoint(str(root / "jax" / "ckpt_2"), template)
    a = jax.tree_util.tree_flatten_with_path(mine)[0]
    b = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(p))
