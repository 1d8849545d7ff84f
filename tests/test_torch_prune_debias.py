"""`python -m crvqa_tpu_torch.cli.prune_debias_vqa --device cpu --tiny` end
to end on the fabricated VQA-CP files of tests/test_dress_rehearsal.py
(real WordPiece tokenizer, bias priors, the feature pickle): the run
writes `mask.pt`, `classifier4masker.bin` and `test.json` that the JAX
package's readers load and that the port's `serve_vqa --device cpu` serves
without an error response; `--resume_from` continues the step count; the
flags of paths not yet ported raise (the runtime's, in one process, raise
the mesh's and the launcher's own errors or, `--zero_opt`, run); without a
card the CLI raises unless
given `--device cpu`.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.core import torch_compat as jcompat
from crvqa_tpu.masking import lxmert_mask_specs as jax_specs
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu_torch.cli import prune_debias_vqa, serve_vqa
from tests.test_dress_rehearsal import ANSWERS, _fabricate


def _argv(root, out, *extra):
    return ["--output_dir", str(out), "--tiny", "--device", "cpu",
            "--dataroot", str(root),
            "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
            "--vocab_file", str(root / "vocab.txt"),
            "--train_batch_size", "8", "--eval_batch_size", "8",
            "--num_train_epochs", "2", "--logging_steps", "2",
            "--save_steps", "4", "--dtype", "float32", "--do_train",
            "--do_eval", "--evaluate_during_training", "--seed", "0",
            "--Masker_type", "lmh", "--controlled_init", "magnitude",
            *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage2")
    _fabricate(root)
    out = root / "s2"
    summary = prune_debias_vqa.main(_argv(root, out))
    return root, out, summary


def test_run_writes_the_artifacts(run):
    root, out, summary = run
    assert summary["step"] == 8  # 32 train questions / 8 x 2 epochs
    assert len(summary["losses"]) == 8
    assert all(np.isfinite(summary["losses"]))
    for modality in ("Lang", "Vis", "Fus", "P"):
        assert abs(summary["zero_rates"][modality] - 0.7) < 0.02
    preds = json.load(open(out / "test.json"))
    assert len(preds) == 20  # every test question answered once
    assert all(p["answer"] in ANSWERS for p in preds)
    assert sorted(p["question_id"] for p in preds) == list(range(5000, 5020))
    lines = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [x["step"] for x in lines if "loss" in x] == [2, 4, 6, 8]
    assert (out / "eval_results_vqa.txt").exists()
    ckpts = sorted(p.name for p in out.iterdir()
                   if p.name.startswith("ckpt_") and "." not in p.name)
    assert ckpts == ["ckpt_4", "ckpt_8"]


def test_jax_readers_load_the_artifacts(run):
    _, out, _ = run
    cfg = JaxConfig.tiny()
    params = JaxLxmert(cfg).init(
        jax.random.PRNGKey(0), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, cfg.visual_pos_dim)))["params"]
    specs = jax_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers)
    masks = jcompat.import_mask_pt(str(out / "mask.pt"), specs)
    zeros = total = 0
    for spec in specs:
        leaf = params
        for p in spec.path:
            leaf = leaf[p]
        assert masks[spec.key].shape == leaf.shape, spec.key
        zeros += int((~masks[spec.key]).sum())
        total += masks[spec.key].size
    assert abs(zeros / total - 0.7) < 0.02
    clf = jcompat.import_classifier_bin(str(out / "classifier4masker.bin"),
                                        params["classifier"])
    for layer in ("main_0", "main_3"):
        for name in ("v", "g", "bias"):
            assert clf[layer][name].shape == params["classifier"][layer][
                name].shape


def test_port_server_serves_the_artifacts(run, tmp_path):
    root, out, _ = run
    questions = json.load(open(root / "vqacp_v2_test_questions.json"))[:6]
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text("".join(json.dumps(
        {"question_id": q["question_id"], "question": q["question"],
         "image_id": q["image_id"]}) + "\n" for q in questions))
    responses = tmp_path / "responses.jsonl"
    stats = serve_vqa.main([
        "--tiny", "--dtype", "float32", "--seed", "0", "--device", "cpu",
        "--dataroot", str(root),
        "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
        "--vocab_file", str(root / "vocab.txt"),
        "--mask_pt", str(out / "mask.pt"),
        "--classifier_bin", str(out / "classifier4masker.bin"),
        "--input", str(reqs), "--output", str(responses),
        "--serve_batch_size", "4", "--max_wait_ms", "1"])
    got = [json.loads(x) for x in open(responses)]
    assert stats["requests"] == len(got) == 6
    assert not [r for r in got if "error" in r]
    assert all(r["answer"] in ANSWERS for r in got)


def test_resume_continues_the_step_count(run, tmp_path):
    root, out, _ = run
    resumed = prune_debias_vqa.main(
        _argv(root, tmp_path / "resumed", "--resume_from",
              str(out / "ckpt_4"), "--num_train_epochs", "1"))
    assert resumed["step"] == 4 + 4
    raw = torch.load(out / "ckpt_4", weights_only=True)
    assert raw["step"] == 4 and raw["opt_state"]["count"] == 4


@pytest.mark.parametrize("flag,value,error,match", [
    pytest.param("--scan_layers", "true", NotImplementedError,
                 "not yet ported", id="--scan_layers-true"),
    pytest.param("--steps_per_dispatch", "4", NotImplementedError,
                 "not yet ported", id="--steps_per_dispatch-4"),
    # ported: ZeRO over one data rank runs (and shards nothing)
    pytest.param("--zero_opt", "true", None, None, id="--zero_opt-true"),
    # ported (tensor parallelism): a model axis of 2 over one process is
    # the mesh's own error
    pytest.param("--mesh_model", "2", ValueError, "does not cover 1 devices",
                 id="--mesh_model-2"),
    # ported: without a world to join it raises instead of training alone
    pytest.param("--multihost", "true", ValueError, "torchrun",
                 id="--multihost-true")])
def test_unported_flags_raise(tmp_path, monkeypatch, flag, value, error,
                              match):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--output_dir", str(tmp_path), "--tiny", "--device", "cpu",
            "--synthetic", "8", "--train_batch_size", "4",
            "--num_train_epochs", "1", "--do_train", flag, value]
    if error is None:
        assert prune_debias_vqa.main(argv)["step"] == 2
        return
    with pytest.raises(error, match=match):
        prune_debias_vqa.main(argv)


def test_without_a_card_the_default_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        prune_debias_vqa.main(["--output_dir", str(tmp_path), "--tiny",
                               "--synthetic", "8"])
