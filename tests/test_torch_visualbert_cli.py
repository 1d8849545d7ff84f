"""VisualBERT's entry points: `crvqa_tpu_torch.cli.prune_debias_vqa_visualbert`
and `crvqa_tpu_torch.cli.serve_vqa --model_type visualbert` vs the JAX
CLIs of the same names, on the same argv (the port adds `--device cpu`).

- Stage 2 from a stage-1 checkpoint exported from JAX params: the port's
  `mask.pt` and `classifier4masker.bin` have the JAX CLI's keys, dtypes
  and shapes (each weight-norm g a scalar), and the JAX readers (`torch_compat.import_mask_pt`,
  `overlay_classifier(key="cls")`) load them.
- Serving those artifacts over the fabricated VQA-CP files of
  tests/test_dress_rehearsal.py: responses match in order and answer, with
  prob within 1e-5 (fp32; the two forwards differ in summation order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.cli import common as jcommon
from crvqa_tpu.cli import prune_debias_vqa_visualbert as jcli
from crvqa_tpu.cli import serve_vqa as jserve
from crvqa_tpu.core import torch_compat as jcompat
from crvqa_tpu.masking import visualbert_mask_specs as jax_specs
from crvqa_tpu.models.visualbert import VisualBertConfig as JaxConfig
from crvqa_tpu.models.visualbert import VisualBertForVQA as JaxVisualBert
from crvqa_tpu_torch.cli import prune_debias_vqa_visualbert as tcli
from crvqa_tpu_torch.cli import serve_vqa as tserve
from crvqa_tpu_torch.core.torch_compat import load_state_dict_file
from crvqa_tpu_torch.ops.fused_attention import fused_attention
from tests.test_dress_rehearsal import _fabricate

# the flags of tests/test_cli_mplug_visualbert.py::test_visualbert_stage2_cli
STAGE2_ARGV = ["--tiny", "--synthetic", "32", "--zero_rate", "0.7",
               "--Masker_type", "lmh", "--train_batch_size", "8",
               "--eval_batch_size", "8", "--num_train_epochs", "1",
               "--logging_steps", "2", "--save_steps", "4",
               "--warmup_steps", "0", "--dtype", "float32", "--do_train",
               "--do_eval", "--evaluate_during_training", "--seed", "0"]


def _jax_params(seed):
    cfg = JaxConfig.tiny()
    return JaxVisualBert(cfg).init(
        jax.random.PRNGKey(seed), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_embeds=jnp.zeros((2, 8, cfg.visual_embedding_dim)))["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both stage-2 CLIs on one argv from one stage-1 .bin, and the
    fabricated serving files."""
    root = tmp_path_factory.mktemp("visualbert")
    _fabricate(root)
    params = _jax_params(11)
    jcompat.save_torch_state_dict(str(root / "stage1.bin"), params)
    argv = STAGE2_ARGV + ["--stage1_ckpt", str(root / "stage1.bin")]
    jcli.main(["--output_dir", str(root / "jax")] + argv)
    summary = tcli.main(["--output_dir", str(root / "torch"), "--device",
                         "cpu"] + argv)
    questions = json.load(open(root / "vqacp_v2_test_questions.json"))[:10]
    reqs = [{"question_id": q["question_id"], "question": q["question"],
             "image_id": q["image_id"]} for q in questions]
    reqs.insert(3, {"question_id": 77, "question": "what?",
                    "image_id": "no_such"})
    with open(root / "requests.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    return dict(root=root, params=params, summary=summary)


def test_stage2_cli_runs_and_reports(runs):
    s = runs["summary"]
    assert s["step"] == 4 and len(s["losses"]) == 4
    assert all(np.isfinite(s["losses"]))
    assert abs(s["zero_rates"]["Uni"] - 0.7) < 0.01
    out = runs["root"] / "torch"
    for name in ("mask.pt", "classifier4masker.bin", "test.json",
                 "eval_results_vqa.txt", "ckpt_4"):
        assert (out / name).exists(), name
    assert len(json.load(open(out / "test.json"))) == 32


def test_stage2_artifacts_match_the_jax_cli_and_load_in_jax(runs):
    root = runs["root"]
    got = torch.load(root / "torch" / "mask.pt")
    want = torch.load(root / "jax" / "mask.pt", weights_only=False)
    assert list(got) == list(want)
    assert "visual_bert.encoder.layer.0.attention.self.query.weight" in got
    for name, m in got.items():
        assert m.dtype == torch.bool and m.shape == want[name].shape, name
    specs = jax_specs(JaxConfig.tiny().num_hidden_layers)
    masks = jcompat.import_mask_pt(str(root / "torch" / "mask.pt"), specs)
    zeros = sum(int((~np.asarray(m)).sum()) for m in masks.values())
    total = sum(np.asarray(m).size for m in masks.values())
    assert abs(zeros / total - 0.7) < 0.01

    clf = load_state_dict_file(str(root / "torch" / "classifier4masker.bin"))
    jclf = load_state_dict_file(str(root / "jax" / "classifier4masker.bin"))
    # the same entries and sizes; each weight-norm g is a scalar here, as
    # torch's weight_norm(dim=None) keeps it, and [1] in the JAX CLI's file
    assert {k: v.numel() for k, v in clf.items()} == {
        k: v.numel() for k, v in jclf.items()}
    assert all(clf[k].shape == jclf[k].shape for k in clf
               if not k.endswith("weight_g"))
    overlaid = jcommon.overlay_classifier(
        runs["params"], str(root / "torch" / "classifier4masker.bin"),
        key="cls")
    np.testing.assert_array_equal(
        np.asarray(overlaid["cls"]["main_3"]["v"]),
        clf["main.3.weight_v"].numpy().T)


def _serve_argv(root, out):
    art = root / "torch"
    return ["--model_type", "visualbert", "--tiny", "--dtype", "float32",
            "--seed", "3", "--dataroot", str(root),
            "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
            "--vocab_file", str(root / "vocab.txt"),
            "--ckpt", str(root / "stage1.bin"),
            "--mask_pt", str(art / "mask.pt"),
            "--classifier_bin", str(art / "classifier4masker.bin"),
            "--input", str(root / "requests.jsonl"), "--output", str(out),
            "--serve_batch_size", "4", "--max_wait_ms", "1"]


def test_serve_matches_jax_server(runs):
    root = runs["root"]
    jserve.main(_serve_argv(root, root / "jax.jsonl"))
    before = fused_attention.launches
    stats = tserve.main(_serve_argv(root, root / "torch.jsonl")
                        + ["--device", "cpu"])
    assert fused_attention.launches == before
    want = [json.loads(line) for line in open(root / "jax.jsonl")]
    got = [json.loads(line) for line in open(root / "torch.jsonl")]
    assert stats["requests"] == len(got) == len(want) == 11
    assert [g["question_id"] for g in got] == [w["question_id"] for w in want]
    assert "no_such" in got[3]["error"] and "no_such" in want[3]["error"]
    for g, w in zip(got, want):
        if "error" in w:
            continue
        assert g["answer"] == w["answer"]
        assert abs(g["prob"] - w["prob"]) <= 1e-5


def test_served_weights_are_pruned_and_overlaid(runs):
    """The stage-2 artifacts reach the VisualBERT model: masked weights are
    exactly zero where mask.pt says so, and `cls` is the .bin's."""
    root = runs["root"]
    args = tserve.build_parser().parse_args(
        _serve_argv(root, root / "unused.jsonl") + ["--device", "cpu"])
    sd = tserve.build_serving_model(args, torch.device("cpu")).state_dict()
    masks = torch.load(root / "torch" / "mask.pt")
    assert len(masks) == 6 * 2 + 2
    for name, mask in masks.items():
        assert torch.all(sd[name][~mask] == 0), name
    clf = load_state_dict_file(str(root / "torch" / "classifier4masker.bin"))
    for name, t in clf.items():
        assert torch.equal(sd["cls." + name].reshape(t.shape), t)


@pytest.mark.parametrize("cli", ["stage2", "serve"])
def test_without_a_card_the_default_device_raises(runs, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        if cli == "stage2":
            tcli.main(["--output_dir", str(tmp_path), "--tiny",
                       "--synthetic", "8"])
        else:
            tserve.main(_serve_argv(runs["root"], tmp_path / "never.jsonl"))


@pytest.mark.parametrize("extra,error", [
    pytest.param(["--model_type", "lxmert"], NotImplementedError,
                 id="extra0"),
    # a mesh of 2 data ranks over one process: the mesh's own error
    pytest.param(["--mesh_data", "2"], ValueError, id="extra1")])
def test_stage2_cli_refuses_what_it_does_not_run(tmp_path, extra, error):
    with pytest.raises(error):
        tcli.main(["--output_dir", str(tmp_path), "--tiny", "--device",
                   "cpu", "--synthetic", "8"] + extra)
