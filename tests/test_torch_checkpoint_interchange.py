"""Checkpoint interchange between the port and the JAX package through
the JAX package's msgpack params files, on the fabricated VQA-CP files of
tests/test_dress_rehearsal.py at the tiny config (fp32, the CLIs' default
dropout; the JAX package writes its checkpoints inside the test):

- the JAX stage-1 CLI's `.msgpack` twin, read by the port's
  `load_params_any`, equals the port's read of the JAX `.bin`, bit for bit;
- the port stage 1's twin, read by the JAX `load_params_any` into the JAX
  tree, equals the JAX package's read of the port's `.bin`, every leaf;
- a JAX stage-3 `_FT_trainedMask.bin.msgpack` served by the port's
  `serve_vqa --ckpt` gives the JAX server's answers, with prob within 1e-5
  (fp32; the two forwards differ only in summation order, the tolerance
  of tests/test_torch_serve.py);
- the port's stage-3 `.msgpack` reads in the JAX loader;
- a VisualBERT msgpack `--stage1_ckpt` written by the JAX `save_checkpoint`
  gives the port the same starting params;
- `jax_tree_from_state_dict` inverts `state_dict_from_jax` on the LXMERT
  and VisualBERT trees the JAX package builds;
- a JAX `ckpt_<step>` given to `--resume_from` is refused with a clear
  error by every LXMERT / VisualBERT training CLI.
"""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from crvqa_tpu.cli import common as jcommon
from crvqa_tpu.cli import run_vqa_stage1 as jstage1
from crvqa_tpu.cli import run_vqa_stage3 as jstage3
from crvqa_tpu.cli import serve_vqa as jserve
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.core import torch_compat as jcompat
from crvqa_tpu.masking import lxmert_mask_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu.models.visualbert import VisualBertConfig as JaxVBConfig
from crvqa_tpu.models.visualbert import VisualBertForVQA as JaxVisualBert
from crvqa_tpu.native import feature_store as jstore
from crvqa_tpu_torch.cli import common as tcommon
from crvqa_tpu_torch.cli import prune_debias_vqa
from crvqa_tpu_torch.cli import prune_debias_vqa_visualbert
from crvqa_tpu_torch.cli import run_vqa_stage1, run_vqa_stage3
from crvqa_tpu_torch.cli import serve_vqa as tserve
from crvqa_tpu_torch.core.convert import (jax_tree_from_state_dict,
                                          state_dict_from_jax)
from crvqa_tpu_torch.models import (LxmertConfig, VisualBertConfig,
                                    build_lxmert, build_visualbert)
from tests.test_dress_rehearsal import _fabricate

TRAIN = ["--tiny", "--dtype", "float32", "--seed", "0",
         "--train_batch_size", "8", "--eval_batch_size", "8",
         "--FT_type", "lmh", "--num_train_epochs", "1"]


def _data(root):
    return ["--dataroot", str(root),
            "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
            "--vocab_file", str(root / "vocab.txt")]


def _lxmert_template():
    cfg = JaxConfig.tiny()
    return JaxLxmert(cfg).init(
        jax.random.PRNGKey(0), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, cfg.visual_pos_dim)))["params"]


def _visualbert_params(seed):
    cfg = JaxVBConfig.tiny()
    return JaxVisualBert(cfg).init(
        jax.random.PRNGKey(seed), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_embeds=jnp.zeros((2, 8, cfg.visual_embedding_dim)))["params"]


def _leaves(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX stage 1 (best-eval save at step 4, its `.bin`, `.msgpack`
    and msgpack `ckpt_4`), the JAX stage 3 from its twin with a
    fabricated mask.pt, the port's stage 1 and stage 3 on the same argv,
    and the serving files."""
    root = tmp_path_factory.mktemp("interchange")
    _fabricate(root)
    cfg = JaxConfig.tiny()
    specs = lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers)
    leaves = {tuple(k.key for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(_lxmert_template())[0]}
    rng = np.random.default_rng(5)
    masks = {s.key: rng.random(leaves[s.path].shape) > 0.7 for s in specs}
    jcompat.export_mask_pt(str(root / "mask.pt"), masks, specs)
    stage1 = TRAIN + _data(root) + ["--logging_steps", "2", "--save_steps",
                                    "4", "--do_train",
                                    "--evaluate_during_training"]
    jstage1.main(["--output_dir", str(root / "jax_s1")] + stage1)
    run_vqa_stage1.main(["--output_dir", str(root / "port_s1"), "--device",
                         "cpu"] + stage1)
    stage3 = TRAIN + _data(root) + ["--mask_pt", str(root / "mask.pt"),
                                    "--logging_steps", "2", "--save_steps",
                                    "100", "--do_train"]
    jstage3.main(["--output_dir", str(root / "jax_s3"), "--stage1_ckpt",
                  str(root / "jax_s1" / "run_FTlmh_only.bin.msgpack")]
                 + stage3)
    run_vqa_stage3.main(["--output_dir", str(root / "port_s3"), "--device",
                         "cpu", "--stage1_ckpt",
                         str(root / "port_s1" / "run_FTlmh_only.bin.msgpack")]
                        + stage3)
    with open(root / "vqa_img_feature_trainval.pickle", "rb") as f:
        jstore.build_feature_store(str(root / "features.bin"),
                                   pickle.load(f))
    questions = json.load(open(root / "vqacp_v2_test_questions.json"))[:10]
    with open(root / "requests.jsonl", "w") as f:
        for q in questions:
            f.write(json.dumps({"question_id": q["question_id"],
                                "question": q["question"],
                                "image_id": q["image_id"]}) + "\n")
    return root


def test_jax_stage1_twin_reads_as_its_bin_in_the_port(runs):
    out = runs / "jax_s1"
    template = build_lxmert(LxmertConfig.tiny(), "cpu",
                            torch.Generator().manual_seed(1)).state_dict()
    from_twin = tcommon.load_params_any(
        str(out / "run_FTlmh_only.bin.msgpack"), template)
    from_bin = tcommon.load_params_any(str(out / "run_FTlmh_only.bin"),
                                       template)
    assert set(from_twin) == set(from_bin) == set(template)
    for k, t in from_bin.items():
        assert from_twin[k].dtype == t.dtype == torch.float32, k
        assert torch.equal(from_twin[k], t), k
    # and not the seeded template's values: the file's
    k = "lxmert.encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(from_twin[k], template[k])


def test_port_stage1_twin_reads_in_the_jax_loader(runs):
    out = runs / "port_s1"
    names = {p.name for p in out.iterdir()}
    assert {"run_FTlmh_only.bin", "run_FTlmh_only.bin.msgpack"} <= names
    template = _lxmert_template()
    from_twin = jcommon.load_params_any(
        str(out / "run_FTlmh_only.bin.msgpack"), template)
    from_bin = jcommon.load_params_any(str(out / "run_FTlmh_only.bin"),
                                       template)
    _assert_trees_equal(from_twin, from_bin)
    # the twin is the JAX package's layout: its key order too
    raw = serialization.msgpack_restore(
        (out / "run_FTlmh_only.bin.msgpack").read_bytes())
    assert list(raw) == sorted(template)
    assert list(raw["lxmert"]) == sorted(template["lxmert"])


def test_jax_stage3_msgpack_served_by_the_port_matches_the_jax_server(runs):
    ckpt = runs / "jax_s3" / "run_FT_trainedMask.bin.msgpack"
    assert ckpt.exists()
    argv = ["--tiny", "--dtype", "float32", "--seed", "3",
            "--dataroot", str(runs), "--img_root", str(runs / "features.bin"),
            "--vocab_file", str(runs / "vocab.txt"), "--ckpt", str(ckpt),
            "--input", str(runs / "requests.jsonl"),
            "--serve_batch_size", "4", "--max_wait_ms", "1"]
    jserve.main(argv + ["--output", str(runs / "jax_served.jsonl")])
    stats = tserve.main(argv + ["--output", str(runs / "port_served.jsonl"),
                                "--device", "cpu"])
    want = [json.loads(line) for line in open(runs / "jax_served.jsonl")]
    got = [json.loads(line) for line in open(runs / "port_served.jsonl")]
    assert stats["requests"] == len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g["question_id"] == w["question_id"]
        assert g["answer"] == w["answer"]
        assert abs(g["prob"] - w["prob"]) <= 1e-5
    # the served weights are the file's: the masked ones exactly 0
    args = tserve.build_parser().parse_args(argv + ["--device", "cpu"])
    sd = tserve.build_serving_model(args, torch.device("cpu")).state_dict()
    mask = torch.load(runs / "mask.pt")
    name = "lxmert.encoder.layer.0.attention.self.query.weight"
    assert not sd[name][~mask[name]].any() and sd[name][mask[name]].all()


def test_port_stage3_msgpack_reads_in_the_jax_loader(runs):
    out = runs / "port_s3"
    template = _lxmert_template()
    from_msgpack = jcommon.load_params_any(
        str(out / "run_FT_trainedMask.bin.msgpack"), template)
    from_bin = jcommon.load_params_any(str(out / "run_FT_trainedMask.bin"),
                                       template)
    _assert_trees_equal(from_msgpack, from_bin)


def test_visualbert_msgpack_stage1_ckpt_gives_the_same_start(tmp_path):
    params = jax.device_get(_visualbert_params(7))
    path = str(tmp_path / "vb_stage1.msgpack")
    jckpt.save_checkpoint(path, params)
    config = VisualBertConfig.tiny()
    got = tcommon.visualbert_initial_params(config, 0, path)
    want = state_dict_from_jax(params)
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    summary = prune_debias_vqa_visualbert.main(
        ["--output_dir", str(tmp_path / "vb"), "--tiny", "--device", "cpu",
         "--synthetic", "8", "--train_batch_size", "8", "--num_train_epochs",
         "1", "--dtype", "float32", "--stage1_ckpt", path, "--do_train"])
    assert summary["step"] == 1 and np.isfinite(summary["losses"][0])


@pytest.mark.parametrize("model", ["lxmert", "visualbert"])
def test_jax_tree_from_state_dict_inverts_state_dict_from_jax(model):
    if model == "lxmert":
        params = jax.device_get(_lxmert_template())
        port = build_lxmert(LxmertConfig.tiny(), "meta")
    else:
        params = jax.device_get(_visualbert_params(3))
        port = build_visualbert(VisualBertConfig.tiny(), "meta")
    state = state_dict_from_jax(params)
    assert set(state) == set(port.state_dict())
    tree = jax_tree_from_state_dict(state, port)
    as_numpy = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    _assert_trees_equal(as_numpy, params)
    # the JAX reader's key check (from_state_dict raises on a missing key)
    # passes, and the key order is the JAX package's
    _assert_trees_equal(serialization.from_state_dict(params, as_numpy),
                        params)
    assert list(tree) == list(params)


RESUME_CLIS = {
    "stage1": (run_vqa_stage1, []),
    "stage3": (run_vqa_stage3, ["--training_type", "FT_randMask"]),
    "stage2": (prune_debias_vqa, []),
    "visualbert": (prune_debias_vqa_visualbert, []),
}


@pytest.mark.parametrize("cli", sorted(RESUME_CLIS))
def test_resume_from_a_jax_ckpt_is_refused(runs, tmp_path, cli):
    """`--resume_from` of the JAX package's msgpack `ckpt_<step>` names the
    format and the ROADMAP instead of failing inside torch.load."""
    module, extra = RESUME_CLIS[cli]
    jax_ckpt = runs / "jax_s1" / "ckpt_4"
    assert jax_ckpt.read_bytes()[:1] in {bytes([b]) for b in range(0x81,
                                                                   0x90)}
    with pytest.raises(NotImplementedError,
                       match="msgpack training state.*ROADMAP"):
        module.main(["--output_dir", str(tmp_path), "--tiny", "--device",
                     "cpu", "--synthetic", "8", "--train_batch_size", "8",
                     "--dtype", "float32", "--do_train", "--resume_from",
                     str(jax_ckpt)] + extra)
