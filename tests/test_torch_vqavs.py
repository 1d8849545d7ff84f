"""The VQA-VS track of the port against the JAX package, on the fabricated
VQA-VS files of tests/test_dress_rehearsal_vqavs.py (real WordPiece
tokenizer, tiny config, fp32, every dropout 0):

- `data.vqavs.load_entries` equals the JAX loader's: token ids, lengths,
  image and question ids, soft targets, argmax labels, question types and
  the bias priors attached from the train split (exact);
- `prune_debias_vqavs` against the JAX CLI on the same argv from one
  stage-1 checkpoint of JAX params: the same artifacts, `test.json` with
  the same answers (fp32 trajectories agree to rounding, far below any
  argmax gap here), and `prefictions_VQAvs_test.json` a copy of it, which
  the port's `compute_vqavs_scores` scores as the JAX one does;
- `--dataset vqavs` runs in stages 1 and 3, and the VQA-VS train split
  ignores `--data_ratio`, as in the JAX package.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crvqa_tpu.cli import prune_debias_vqavs as jcli
from crvqa_tpu.core import torch_compat as jcompat
from crvqa_tpu.data import tokenization as jtok
from crvqa_tpu.data import vqacp as jvqacp
from crvqa_tpu.data import vqavs as jvqavs
from crvqa_tpu.evals import scoring as jscoring
from crvqa_tpu.models import LxmertConfig as JaxConfig
from crvqa_tpu.models import LxmertForVQA as JaxLxmert
from crvqa_tpu_torch.cli import prune_debias_vqavs as tcli
from crvqa_tpu_torch.cli import run_vqa_stage1, run_vqa_stage3
from crvqa_tpu_torch.data import vqacp as tvqacp
from crvqa_tpu_torch.data import vqavs as tvqavs
from crvqa_tpu_torch.evals import scoring as tscoring
from tests.test_dress_rehearsal_vqavs import _fabricate

DROPOUT_0 = ["--hidden_dropout_prob", "0", "--attention_probs_dropout_prob",
             "0", "--classifier_dropout", "0"]


def _data(root):
    return ["--tiny", "--dataroot", str(root),
            "--img_root", str(root / "vqa_img_feature_trainval.pickle"),
            "--vocab_file", str(root / "vocab.txt"),
            "--train_batch_size", "8", "--eval_batch_size", "8",
            "--dtype", "float32", "--seed", "0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqavs")
    payload = _fabricate(root)
    cfg = JaxConfig.tiny()
    params = JaxLxmert(cfg).init(
        jax.random.PRNGKey(11), input_ids=jnp.ones((2, 14), jnp.int32),
        visual_feats=jnp.zeros((2, 8, cfg.visual_feat_dim)),
        visual_pos=jnp.zeros((2, 8, cfg.visual_pos_dim)))["params"]
    jcompat.save_torch_state_dict(str(root / "stage1.bin"), params)
    argv = _data(root) + DROPOUT_0 + [
        "--stage1_ckpt", str(root / "stage1.bin"), "--num_train_epochs", "1",
        "--logging_steps", "2", "--save_steps", "2", "--warmup_steps", "0",
        "--Masker_type", "normal", "--zero_rate", "0.7", "--Lang_comp",
        "0.3", "--Vis_comp", "0.3", "--Fus_comp", "0.3", "--controlled_init",
        "magnitude", "--do_train", "--do_eval",
        "--evaluate_during_training"]
    jcli.main(["--output_dir", str(root / "jax")] + argv)
    summary = tcli.main(["--output_dir", str(root / "port"), "--device",
                         "cpu"] + argv)
    return dict(root=root, payload=payload, summary=summary)


def test_load_entries_match_the_jax_loader(tmp_path):
    _fabricate(tmp_path)
    vocab = str(tmp_path / "vocab.txt")
    ans2label, label2ans = tvqavs.load_answer_vocab(str(tmp_path))
    assert (ans2label, label2ans) == jvqavs.load_answer_vocab(str(tmp_path))
    n = len(ans2label)
    port = {s: tvqavs.load_entries(str(tmp_path), s, tvqacp.make_tokenizer(
        vocab), n) for s in ("train", "test")}
    jax_ = {s: jvqavs.load_entries(str(tmp_path), s, jtok.WordPieceTokenizer(
        vocab_file=vocab, native=False), n) for s in ("train", "test")}
    port_priors = tvqacp.compute_bias_priors(port["train"], n)
    jax_priors = jvqacp.compute_bias_priors(jax_["train"], n)
    assert sorted(port_priors) == sorted(jax_priors)
    for split in ("train", "test"):
        tvqacp.attach_bias(port[split], port_priors, n)
        jvqacp.attach_bias(jax_[split], jax_priors, n)
        got, want = port[split], jax_[split]
        for field in ("input_ids", "lengths", "image_ids", "question_ids",
                      "labels", "max_label", "bias"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert got.question_types == want.question_types
    assert len(port["train"]) == 32 and len(port["test"]) == 24
    with pytest.raises(ValueError, match="VQA-VS split"):
        tvqavs.load_entries(str(tmp_path), "dev", None, n)


def test_prune_debias_vqavs_matches_the_jax_cli(runs):
    root, summary = runs["root"], runs["summary"]
    assert summary["step"] == 4 and all(np.isfinite(summary["losses"]))
    port, jax_ = root / "port", root / "jax"
    assert set(os.listdir(port)) == set(os.listdir(jax_))
    for out in (port, jax_):
        assert (out / "prefictions_VQAvs_test.json").read_bytes() == (
            out / "test.json").read_bytes()
    got = json.load(open(port / "test.json"))
    want = json.load(open(jax_ / "test.json"))
    assert len(got) == len(want) == 24
    assert ({p["question_id"]: p["answer"] for p in got}
            == {p["question_id"]: p["answer"] for p in want})
    scores = tscoring.compute_vqavs_scores(got, runs["payload"])
    assert scores == jscoring.compute_vqavs_scores(got, runs["payload"])
    assert set(scores) == {"iid", "Final_Score", *tscoring.VQAVS_SPLITS}


def test_stages_1_and_3_take_the_vqavs_files(runs, tmp_path):
    root = runs["root"]
    s1 = run_vqa_stage1.main(
        ["--output_dir", str(tmp_path / "s1"), "--device", "cpu",
         "--dataset", "vqavs", "--data_ratio", "0.5", "--FT_type", "lmh",
         "--num_train_epochs", "1", "--do_train", "--do_eval"]
        + _data(root))
    # 32 train questions at batch 8: the VQA-VS split ignores --data_ratio
    assert s1["step"] == 4 and all(np.isfinite(s1["losses"]))
    s3 = run_vqa_stage3.main(
        ["--output_dir", str(tmp_path / "s3"), "--device", "cpu",
         "--dataset", "vqavs", "--stage1_ckpt",
         str(tmp_path / "s1" / "run_FTlmh_only.bin.msgpack"),
         "--training_type", "FT_randMask", "--FT_type", "lmh",
         "--num_train_epochs", "1", "--do_train", "--do_eval"]
        + _data(root))
    assert s3["step"] == 4 and all(np.isfinite(s3["losses"]))
    for out in ("s1", "s3"):
        preds = json.load(open(tmp_path / out / "test.json"))
        assert sorted(p["question_id"] for p in preds) == list(
            range(7000, 7024))
