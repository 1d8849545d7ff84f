"""The port's mPLUG trainer (`crvqa_tpu_torch.cli.vqa_mplug`) end to end on
the CPU at tiny widths: on `--synthetic` batches (train with threshold
resets on a moving target, checkpoints, resume, final reset, exports, beam
and rank evaluation) and on the files the JAX package's mPLUG rehearsal
fabricates (annotation JSONs, JPEGs, a toy vocab), whose loaders are held
against the JAX package's; `mask.pt` carries the JAX CLI's keys; `serve_mplug
--ckpt` serves what the trainer wrote; the flags not yet ported raise;
the reset's k against the JAX package's, where the two differ by one.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crvqa_tpu.ops import kthvalue as jkthvalue
from crvqa_tpu_torch.cli import serve_mplug, vqa_mplug
from crvqa_tpu_torch.ops import kthvalue
from crvqa_tpu_torch.core import checkpoint as ckpt
from tests.test_dress_rehearsal_mplug import ANSWERS, _fabricate


def _argv(out, extra=()):
    return ["--device", "cpu", "--tiny", "--dtype", "float32", "--seed", "7",
            "--output_dir", str(out), "--synthetic", "16",
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--num_train_epochs", "2", "--masker_update_step", "2",
            "--logging_steps", "2", "--save_steps", "3", "--init_sparsity",
            "0.3", "--final_sparsity_epoch", "1", "--beam_size", "2",
            "--max_answer_len", "5", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One mask-mode run: 8 steps, resets every 2, checkpoints every 3."""
    out = tmp_path_factory.mktemp("mask")
    summary = vqa_mplug.main(_argv(out, ["--do_train", "--do_eval"]))
    return out, summary


def test_train_writes_its_artifacts(trained):
    out, summary = trained
    assert summary["step"] == 8 and len(summary["losses"]) == 8
    assert all(np.isfinite(summary["losses"]))
    names = {p.name for p in out.iterdir()}
    assert {"args.txt", "mask_config.json", "mask.pt", "ckpt_final",
            "ckpt_final.meta.json", "metrics.jsonl", "vqa_result.json",
            "ckpt_3", "ckpt_6"} <= names
    assert json.load(open(out / "mask_config.json")) == {
        "zero_rate": 0.5, "threshold": 0.01, "init_scale": 0.02,
        "controlled_init": "magnitude_soft", "masker_update_step": 2}
    results = json.load(open(out / "vqa_result.json"))
    assert summary["num_predictions"] == len(results) == 16
    assert all(set(r) == {"question_id", "answer"} for r in results)
    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [m["step"] for m in lines if "ex_s" in m] == [2, 4, 6, 8]


def test_thresholds_follow_the_moving_target(trained):
    """Reset every 2 steps at the fractional epoch: the target climbs the
    cubic schedule from 0.3 to 0.5 by epoch 1, and each reset lands the
    achieved zero rate on it (within one k-th-value step of the tiny
    matrices); the final reset is at the zero rate."""
    _, summary = trained
    steps, targets, achieved = zip(*summary["resets"])
    assert steps == (2, 4, 6, 8)
    assert targets[0] < targets[1] < targets[2] == targets[3] == 0.5
    assert 0.3 < targets[0] < 0.5
    for t, a in zip(targets, achieved):
        assert abs(t - a) < 2e-3
    assert abs(summary["zero_rates"]["all"] - 0.5) < 2e-3


# The reset's k = int(n * target): the port forms n * target in float64 (a
# Python float, as the reference's int(numel * sparsity)); the JAX trainer
# passes the target as an fp32 scalar (crvqa_tpu/train/mplug_train.py:554),
# so JAX forms it in fp32 and, on some targets, masks one weight more. The
# trajectory tests above and in test_torch_mplug_train.py hold thresholds
# at targets where the two agree; the test below pins one where they do
# not.
MOVED_TARGET = 0.4499062323188823
FFN_N = 768 * 3072


def test_reset_k_is_float64_and_one_below_jax_at_this_target():
    """On scores 0, 1, ..., n - 1 the k-th smallest is k - 1: the port
    keeps k = int(n * target) in float64 (1061461); JAX's
    `sparsity_threshold` on the fp32 target gives 1061462."""
    scores = np.arange(FFN_N, dtype=np.float32)
    port_k = int(kthvalue.sparsity_threshold(torch.from_numpy(scores),
                                             MOVED_TARGET)) + 1
    jax_k = int(jkthvalue.sparsity_threshold(
        jnp.asarray(scores), jnp.asarray(MOVED_TARGET, jnp.float32))) + 1
    assert port_k == int(FFN_N * MOVED_TARGET) == 1061461
    assert jax_k == 1061462 == port_k + 1


def test_resume_carries_on_from_the_checkpoint(trained, tmp_path):
    """`--resume_from ckpt_6` restores step and optimizer count, then runs
    its epochs (as the JAX CLI does); the checkpoint holds the trained
    leaves only."""
    out, summary = trained
    again = vqa_mplug.main(_argv(tmp_path, [
        "--do_train", "--resume_from", str(out / "ckpt_6")]))
    # the resumed loop replays the epochs' batches from its first one: the
    # step counter and the optimizer carry on from 6
    assert again["step"] == 6 + 8
    raw = torch.load(out / "ckpt_6", weights_only=True)
    assert raw["step"] == 6 and raw["opt_state"]["count"] == 6
    assert set(raw["params"]) == {
        "text_decoder.cls.predictions." + n for n in (
            "bias", "transform.dense.weight", "transform.dense.bias",
            "transform.LayerNorm.weight", "transform.LayerNorm.bias")}
    assert raw["params_m"] is None and raw["scores_m"] is None


def test_resume_restores_the_state_bit_for_bit(trained, tmp_path):
    out, _ = trained
    args = vqa_mplug.build_parser().parse_args(_argv(tmp_path))
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    cfg = vqa_mplug.train_config(args, 4)
    from crvqa_tpu_torch.train import mplug_train

    def fresh():
        return mplug_train.init_state(
            model, vqa_mplug.initial_params(args, config), cfg, "cpu",
            masker=masker, seed=args.seed, train=True)

    a = ckpt.load_mplug_checkpoint(str(out / "ckpt_final"), fresh())
    path = tmp_path / "again"
    ckpt.save_mplug_checkpoint(str(path), a)
    b = ckpt.load_mplug_checkpoint(str(path), fresh())
    assert a.step == b.step == 8 and b.opt_state.count == 8
    for k in a.scores:
        assert torch.equal(a.scores[k], b.scores[k])
        assert torch.equal(a.thresholds[k], b.thresholds[k])
        assert torch.equal(a.opt_state.nu[f"scores/{k}"],
                           b.opt_state.nu[f"scores/{k}"])
    assert torch.equal(a.rng.host.get_state(), b.rng.host.get_state())
    assert not torch.equal(a.scores[k], fresh().scores[k])
    ckpt.rotate_checkpoints(str(out), keep=1)
    assert not (out / "ckpt_3").exists() and (out / "ckpt_6").exists()


@pytest.mark.parametrize("distill", [False, True])
def test_mask_pt_keys_equal_the_jax_cli(tmp_path, distill):
    """Both CLIs, one argv: the same `mask.pt` keys and shapes (with
    --distill the twins' masks under `_m` names too; --mask_classifier adds
    the twin's LM-head transform)."""
    from crvqa_tpu.cli import vqa_mplug as jcli

    # batch 8: the JAX CLI shards each batch over its 8 virtual CPU devices
    extra = ["--do_train", "--num_train_epochs", "1", "--train_batch_size",
             "8", "--distill", str(distill), "--mask_classifier", "true",
             "--save_steps", "0"]
    jargv = [a for a in _argv(tmp_path / "jax", extra)
             if a not in ("--device", "cpu")]
    jcli.main(jargv)
    summary = vqa_mplug.main(_argv(tmp_path / "port", extra))
    assert len(summary["losses"]) == 2
    want = torch.load(tmp_path / "jax" / "mask.pt", weights_only=True)
    got = torch.load(tmp_path / "port" / "mask.pt", weights_only=True)
    assert set(got) == set(want)
    assert any(k.startswith("text_decoder_m.") for k in got)
    assert any(k.startswith("visual_encoder_m.") for k in got) == distill
    for k in want:
        assert got[k].dtype == torch.bool and got[k].shape == want[k].shape
        assert 0.4 < 1 - got[k].float().mean() < 0.6, k


@pytest.mark.parametrize("extra", [["--mode", "full"],
                                   ["--mode", "full", "--distill", "true"],
                                   ["--distill", "true"],
                                   ["--sched", "tanh"],
                                   ["--warmup_steps", "2", "--sched", "step"],
                                   ["--mask_biases", "true"]],
                         ids=lambda e: "_".join(x.strip("-") for x in e))
def test_other_modes_train(tmp_path, extra):
    summary = vqa_mplug.main(_argv(tmp_path, [
        "--do_train", "--num_train_epochs", "1", *extra]))
    assert summary["step"] == 4 and all(np.isfinite(summary["losses"]))
    assert (tmp_path / "ckpt_final").exists()
    assert (tmp_path / "mask.pt").exists() == ("full" not in extra)


def test_full_mode_trains_every_parameter(tmp_path):
    vqa_mplug.main(_argv(tmp_path, ["--do_train", "--mode", "full",
                                    "--num_train_epochs", "1"]))
    raw = torch.load(tmp_path / "ckpt_final", weights_only=True)
    assert raw["scores"] is None
    assert "visual_encoder.visual.conv1.weight" in raw["params"]
    assert ("text_decoder.bert.embeddings.word_embeddings.weight"
            in raw["params"])
    assert set(raw["opt_state"]["mu"]) == {"params/" + k
                                           for k in raw["params"]}


@pytest.mark.parametrize("depth", ["0", "3"])
def test_eval_pipeline_depth_changes_no_answer(trained, tmp_path, depth):
    out, _ = trained
    vqa_mplug.main(_argv(tmp_path, [
        "--do_eval", "--resume_from", str(out / "ckpt_final"),
        "--eval_pipeline_depth", depth]))
    assert (json.load(open(tmp_path / "vqa_result.json"))
            == json.load(open(out / "vqa_result.json")))


def test_rank_evaluation_on_synthetic(tmp_path):
    summary = vqa_mplug.main(_argv(tmp_path, ["--do_eval", "--eval_method",
                                              "rank", "--k_test", "3"]))
    results = json.load(open(tmp_path / "vqa_result.json"))
    assert summary["num_predictions"] == 16
    assert all(r["answer"].startswith("ans_") for r in results)


# ---------------------------------------------------------------- on files

@pytest.fixture
def root(tmp_path):
    _fabricate(tmp_path)
    return tmp_path


def _file_argv(root, out, extra=()):
    return ["--device", "cpu", "--tiny", "--dtype", "float32", "--seed",
            "11", "--output_dir", str(out), "--vocab_file",
            str(root / "vocab.txt"), "--train_files",
            str(root / "vqa_train.json"), "--test_files",
            str(root / "vqa_test.json"), "--vqa_root", str(root),
            "--image_res", "32", "--train_batch_size", "4",
            "--eval_batch_size", "3", "--num_train_epochs", "1",
            "--masker_update_step", "2", "--logging_steps", "2",
            "--beam_size", "2", "--max_answer_len", "6", "--data_workers",
            "2", "--augment", "false", *extra]


def test_loaders_equal_the_jax_package(root):
    """`load_entries` (answer dedup, weights, bias by answer, OCR / object
    splicing) and `iterate_batches` (shuffle order, ragged tail, drop_last)
    field by field."""
    from crvqa_tpu.data import mplug_data as jdata
    from crvqa_tpu.data.tokenization import WordPieceTokenizer as JTok
    from crvqa_tpu_torch.data import mplug_data as tdata
    from crvqa_tpu_torch.data.tokenization import WordPieceTokenizer

    vocab = str(root / "vocab.txt")
    kw = dict(q_len=12, a_len=6, answers_per_question=2,
              vqa_root=str(root), add_ocr=True, add_object=True)
    for name in ("vqa_train.json", "vqa_test.json"):
        want = jdata.load_entries([str(root / name)], JTok(vocab), **kw)
        got = tdata.load_entries([str(root / name)],
                                 WordPieceTokenizer(vocab), **kw)
        assert got.image_paths == want.image_paths
        for f in ("question_ids", "question_tokens", "question_mask",
                  "answer_tokens", "answer_mask", "weights", "bias"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for bkw in (dict(shuffle=True, seed=3, drop_last=True),
                dict(raw_images=True), dict(workers=2)):
        wb = list(jdata.iterate_batches(want, 3, 32, **bkw))
        gb = list(tdata.iterate_batches(got, 3, 32, **bkw))
        assert len(gb) == len(wb) > 0
        for g, w in zip(gb, wb):
            assert g.keys() == w.keys()
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
    assert not gb[-1]["valid"].all()  # 8 records at batch 3: a padded tail


def test_train_eval_and_serve_on_files(root):
    """Train on the annotation files, evaluate by beam and by rank (the
    ragged final batch's pad rows dropped), then `serve_mplug --ckpt` on
    `ckpt_final` answers every test question as the offline evaluation
    did."""
    out = root / "out"
    summary = vqa_mplug.main(_file_argv(root, out, ["--do_train",
                                                    "--do_eval"]))
    assert summary["step"] == 4 and summary["num_predictions"] == 8
    records = json.load(open(root / "vqa_test.json"))
    results = json.load(open(out / "vqa_result.json"))
    assert [r["question_id"] for r in results] == [
        r["question_id"] for r in records]

    rank_out = root / "rank"
    vqa_mplug.main(_file_argv(root, rank_out, [
        "--do_eval", "--resume_from", str(out / "ckpt_final"),
        "--eval_method", "rank", "--answer_list",
        str(root / "answer_list.json"), "--k_test", "3"]))
    ranked = json.load(open(rank_out / "vqa_result.json"))
    assert len(ranked) == 8 and all(r["answer"] in ANSWERS for r in ranked)

    reqs = root / "req.jsonl"
    with open(reqs, "w") as f:
        for r in records:
            f.write(json.dumps({"question_id": r["question_id"],
                                "question": r["question"],
                                "image": str(root / r["image"])}) + "\n")

    def serve(tag, extra):
        resp = root / f"resp_{tag}.jsonl"
        argv = [a for a in _file_argv(root, root / f"serve_{tag}")
                if a != "--augment" and a != "false"]
        stats = serve_mplug.main(argv + [
            "--input", str(reqs), "--output", str(resp),
            "--serve_batch_size", "3", "--max_wait_ms", "1", *extra])
        assert stats["requests"] == 8
        return [json.loads(line) for line in open(resp)]

    served = serve("ckpt", ["--ckpt", str(out / "ckpt_final")])
    assert served == results
    assert not any("error" in r for r in served)


def test_serve_ckpt_loads_what_training_changed(root):
    """`--ckpt` lays the trained head, scores and thresholds over the
    seeded serving state; a checkpoint of another --mode is refused."""
    out = root / "out"
    vqa_mplug.main(_file_argv(root, out, ["--do_train", "--lr1", "1e-2"]))
    args = serve_mplug.build_parser().parse_args(
        _file_argv(root, root / "s") + ["--ckpt", str(out / "ckpt_final")])
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    loaded = serve_mplug.build_state(args, config, model, masker, "cpu")
    args.ckpt = None
    seeded = serve_mplug.build_state(args, config, model, masker, "cpu")
    raw = torch.load(out / "ckpt_final", weights_only=True)
    assert loaded.step == 4 and loaded.opt_state is None
    for k, t in raw["params"].items():
        assert torch.equal(loaded.params[k], t)
    key = next(iter(raw["scores"]))
    assert torch.equal(loaded.scores[key], raw["scores"][key])
    assert not torch.equal(loaded.scores[key], seeded.scores[key])
    bias = "text_decoder.cls.predictions.bias"
    assert not torch.equal(loaded.params[bias], seeded.params[bias])
    args.ckpt, args.mode = str(out / "ckpt_final"), "full"
    with pytest.raises(KeyError, match="--mode"):
        serve_mplug.build_state(args, config, model, None, "cpu")


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("flag", [
    ["--opt", "adamp"], ["--opt", "sgdp"], ["--opt", "adahessian"],
    ["--use_checkpoint", "true"], ["--init_ckpt", "mplug_base.pth"],
    ["--mesh_data", "2"], ["--mesh_model", "2"], ["--multihost", "true"]],
    ids=lambda f: f[0].strip("-") + "_" + f[1])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        vqa_mplug.main(_argv(tmp_path, ["--do_train", *flag]))
    assert not (tmp_path / "ckpt_final").exists()


def test_augment_on_files_raises(root):
    argv = [a for a in _file_argv(root, root / "out", ["--do_train"])
            if a not in ("--augment", "false")]
    with pytest.raises(NotImplementedError, match="--augment"):
        vqa_mplug.main(argv)


def test_without_a_card_the_default_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = [a for a in _argv(tmp_path, ["--do_train"])
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        vqa_mplug.main(argv)
