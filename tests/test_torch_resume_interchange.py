"""Resume in the port from the JAX package's stage-2 training states, and
write them back (`core/convert.stage2_state_from_jax` /
`jax_from_stage2_state`, `core/checkpoint.save_jax_training_state`,
`cli/common.resume_any`), on the tiny configs at fp32 with every dropout
at 0. The JAX stage-1/3 states are tests/test_torch_resume_stages13.py's,
mPLUG's tests/test_torch_resume_mplug.py's.

For LXMERT stage 2 (also with a bf16 backbone and bf16 moments,
`--backbone_dtype` / `--moment_dtype bfloat16`, which keep their dtype),
its `--structured_masking heads` gates and VisualBERT stage 2, the JAX
CLI runs 4 steps (2 epochs over a pool of 2 synthetic
batches, `--synthetic_pool`, so every epoch sees the same batches) and
writes `ckpt_2` and `ckpt_4`. Then:

- the port's CLI resumes from `ckpt_2` and, before any step, its state
  written back in the JAX layout equals the file leaf for leaf, bit for
  bit (the PRNG key too: `TrainRNG` gives back the key it was seeded from
  until it draws);
- the same CLI runs on from `ckpt_2` with the JAX run's argv; its own
  `ckpt_4` is held to the JAX `ckpt_4` (the JAX run's continuation past
  the same file: a JAX resume restores its whole state, and the pool
  gives epoch 2 epoch 1's batches). Tolerances of
  tests/test_torch_stage2.py over 2 steps: the step-4 loss rtol 1e-4;
  scores, classifier and thresholds atol 2 * lr * steps; the moments
  within 1e-3 of the largest value of their moment (`moment_scale`;
  bf16 moments within 1e-2: one bf16 rounding of nearly the same fp32
  value may land one ulp apart); the counts exact;
- the port's JAX-layout file loads in the JAX package's own
  `load_checkpoint` into the JAX CLI's state template, with the leaves of
  the JAX file.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.cli import prune_debias_vqa as jstage2_cli
from crvqa_tpu.cli import prune_debias_vqa_visualbert as jvb_cli
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.masking import Masker as JaxMasker
from crvqa_tpu.masking import ModalSparsity as JaxSparsity
from crvqa_tpu.masking import lxmert_mask_specs as jax_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.train import stage2 as jstage2
from crvqa_tpu_torch.cli import prune_debias_vqa, prune_debias_vqa_visualbert
from crvqa_tpu_torch.core import checkpoint as ckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.masking.spec import (lxmert_mask_specs,
                                          visualbert_mask_specs)
from crvqa_tpu_torch.models import LxmertConfig, VisualBertConfig
from crvqa_tpu_torch.train import stage2
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

LR = 1e-3
DROPOUT_0 = ["--hidden_dropout_prob", "0", "--attention_probs_dropout_prob",
             "0", "--classifier_dropout", "0"]
ARGV = ["--tiny", "--dtype", "float32", "--seed", "0", "--synthetic", "16",
        "--synthetic_pool", "2", "--train_batch_size", "8",
        "--eval_batch_size", "8", "--num_train_epochs", "2",
        "--logging_steps", "2", "--save_steps", "2", "--learning_rate",
        str(LR), "--do_train"] + DROPOUT_0
KINDS = {
    "lxmert": (jstage2_cli, prune_debias_vqa, []),
    "lxmert_bf16_storage": (jstage2_cli, prune_debias_vqa,
                            ["--backbone_dtype", "bfloat16",
                             "--moment_dtype", "bfloat16"]),
    "structured": (jstage2_cli, prune_debias_vqa,
                   ["--structured_masking", "heads"]),
    "visualbert": (jvb_cli, prune_debias_vqa_visualbert, []),
}


def _specs(kind):
    if kind == "visualbert":
        return visualbert_mask_specs(VisualBertConfig.tiny().num_hidden_layers)
    cfg = LxmertConfig.tiny()
    return lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers)


def _model_and_config(kind):
    if kind == "visualbert":
        return (stage2.visualbert_meta_model(VisualBertConfig.tiny(
            dtype=torch.float32)), stage2.Stage2Config(classifier_key="cls"))
    narrow = "bfloat16" if kind == "lxmert_bf16_storage" else "float32"
    return (stage2.lxmert_meta_model(LxmertConfig.tiny(dtype=torch.float32)),
            stage2.Stage2Config(backbone_dtype=narrow, moment_dtype=narrow))


def _array(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def flat(tree, prefix=""):
    """Leaves of a file tree by '/'-path (None and {} kept as markers)."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def moment_scale(leaves, key):
    """The largest |value| of the moment `key` belongs to (mu or nu) over
    every leaf: a gradient that is 0 in exact arithmetic (a key bias under
    softmax) leaves rounding noise in its moments on both sides, which is
    held to the moment's scale, not to its own."""
    slot = "/mu/" if "/mu/" in key else "/nu/"
    return max(float(np.abs(_array(v)).max()) for k, v in leaves.items()
               if slot in k and v is not None and not isinstance(v, dict))


def assert_bit_equal(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, dict):
            assert g is None if w is None else g == {}, k
            continue
        if isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype, k
        a, b = _array(g), _array(w)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module", params=sorted(KINDS))
def run(request, tmp_path_factory):
    kind = request.param
    jcli, tcli, extra = KINDS[kind]
    root = tmp_path_factory.mktemp(kind)
    jcli.main(["--output_dir", str(root / "jax")] + ARGV + extra)
    return kind, root, extra


def _port(kind, root, extra, name, more):
    _, tcli, _ = KINDS[kind]
    return tcli.main(["--output_dir", str(root / name), "--device", "cpu",
                      "--resume_from", str(root / "jax" / "ckpt_2")]
                     + [a for a in ARGV if a != "--do_train"] + extra + more)


def test_resume_is_bit_equal_at_load(run):
    kind, root, extra = run
    state = _port(kind, root, extra, "load", [])["state"]
    model, cfg = _model_and_config(kind)
    assert state.step == 2 and state.opt_state.count == 2
    tree = convert.jax_from_stage2_state(state, model, _specs(kind), cfg)
    assert_bit_equal(tree, ckpt.load_jax_training_state(
        str(root / "jax" / "ckpt_2")))
    # a second resume of the file draws the same numbers
    again = _port(kind, root, extra, "load2", [])["state"]
    for a, b in ((state.rng.device, again.rng.device),
                 (state.rng.host, again.rng.host)):
        assert torch.equal(a.get_state(), b.get_state())


def test_two_steps_match_the_jax_continuation(run):
    kind, root, extra = run
    summary = _port(kind, root, extra, "cont", ["--do_train"])
    state = summary["state"]
    ckpt.load_checkpoint(str(root / "cont" / "ckpt_4"), state)
    model, cfg = _model_and_config(kind)
    got = flat(convert.jax_from_stage2_state(state, model, _specs(kind),
                                             cfg))
    want = flat(ckpt.load_jax_training_state(str(root / "jax" / "ckpt_4")))
    assert set(got) == set(want)
    jloss = [m["loss"] for m in map(json.loads,
                                    open(root / "jax" / "metrics.jsonl"))
             if m.get("step") == 4 and "loss" in m]
    np.testing.assert_allclose(summary["losses"][1], jloss[0], rtol=1e-4)
    atol = 2 * LR * 2
    moved = 0
    start = flat(ckpt.load_jax_training_state(str(root / "jax" / "ckpt_2")))
    for k, w in want.items():
        if k.startswith("/frozen_params") or k == "/rng" or w is None \
                or isinstance(w, dict):
            continue
        a, b = _array(got[k]), _array(w)
        if k.startswith(("/opt_state/1/mu", "/opt_state/1/nu")):
            rel = 1e-2 if kind == "lxmert_bf16_storage" else 1e-3
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=rel * moment_scale(want, k),
                                       err_msg=k)
        elif k.endswith("count") or k == "/step":
            assert int(a) == int(b) == 4, k
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
            moved += not np.array_equal(b, _array(start[k]))
    assert moved > 0


def _jax_stage2_template():
    cfg = JaxConfig.tiny(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0,
                         classifier_dropout=0.0)
    model = JaxLxmert(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, cfg.visual_pos_dim)))
    masker = JaxMasker.create(
        jax_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers),
        JaxSparsity.from_compression(0.3, 0.3, 0.3, 0.7))
    state, _ = jstage2.init_state(
        model, masker, params["params"],
        jstage2.Stage2Config(hidden_size=cfg.hidden_size),
        jax.random.PRNGKey(1))
    return state


@pytest.mark.parametrize("run", ["lxmert"], indirect=True)
def test_port_written_state_loads_in_the_jax_package(run, tmp_path):
    kind, root, extra = run
    state = _port(kind, root, extra, "write", [])["state"]
    model, cfg = _model_and_config(kind)
    path = tmp_path / "ckpt_2"
    ckpt.save_jax_training_state(
        str(path), convert.jax_from_stage2_state(state, model,
                                                 _specs(kind), cfg),
        metadata={"step": 2})
    assert ckpt.checkpoint_format(str(path)) == "jax"
    assert json.load(open(str(path) + ".meta.json")) == {"step": 2}
    template = _jax_stage2_template()
    mine = jckpt.load_checkpoint(str(path), template)
    theirs = jckpt.load_checkpoint(str(root / "jax" / "ckpt_2"), template)
    a = jax.tree_util.tree_flatten_with_path(mine)[0]
    b = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(p))
