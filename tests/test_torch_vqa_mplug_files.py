"""The port's mPLUG trainer (`crvqa_tpu_torch.cli.vqa_mplug`) on the files
the JAX package's mPLUG rehearsal fabricates (annotation JSONs, JPEGs, a
toy vocab), whose loaders are held against the JAX package's; `serve_mplug
--ckpt` serves what the trainer wrote; `--augment true` on files runs (the augmented batches equal the JAX
CLI's; every `--opt` and `--use_checkpoint`:
tests/test_torch_vqa_mplug_opts.py); `--mesh_*` and `--multihost` raise
in one process without a world to cover (their runs are
tests/test_torch_parallel_mplug.py). Split from
tests/test_torch_vqa_mplug.py (its `_argv`).
"""
import json

import numpy as np
import pytest
import torch

from crvqa_tpu_torch.cli import serve_mplug, vqa_mplug
from tests.test_dress_rehearsal_mplug import ANSWERS, _fabricate
from tests.test_torch_vqa_mplug import _argv
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


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

@pytest.mark.parametrize("flag,match", [
    pytest.param(["--mesh_data", "2"], "does not cover 1 devices",
                 id="mesh_data_2"),
    pytest.param(["--mesh_model", "2"], "does not cover 1 devices",
                 id="mesh_model_2"),
    pytest.param(["--multihost", "true"], "torchrun", id="multihost_true")])
def test_unported_flags_raise(tmp_path, monkeypatch, flag, match):
    """The runtime's flags are ported; in one process a mesh that does not
    cover it, or --multihost without a world to join, raises before any
    training."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match=match):
        vqa_mplug.main(_argv(tmp_path, ["--do_train", *flag]))
    assert not (tmp_path / "ckpt_final").exists()


class _Stop(Exception):
    pass


def test_augment_on_files_feeds_the_jax_batches(root, monkeypatch):
    """`--augment true` (the default) on image files: the batches that
    reach the train step are byte-identical to the JAX CLI's (RandAugment
    on every image from one generator per epoch, one spawned child per
    image), and the run writes its artifacts."""
    from crvqa_tpu.cli import vqa_mplug as jcli
    from crvqa_tpu.train import mplug_train as jtrain
    from crvqa_tpu_torch.train import mplug_train as ttrain

    argv = [a for a in _file_argv(root, root / "port", [
        "--do_train", "--train_batch_size", "8", "--save_steps", "0"])
        if a not in ("--augment", "false")]
    seen = {"jax": [], "port": []}

    def jax_spy(*a, **kw):
        def step(state, batch):
            seen["jax"].append({k: np.asarray(v) for k, v in batch.items()})
            if len(seen["jax"]) == 2:
                raise _Stop
            return state, 0.0
        return step

    monkeypatch.setattr(jtrain, "make_train_step", jax_spy)
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    jargv[jargv.index("--output_dir") + 1] = str(root / "jax")
    with pytest.raises(_Stop):
        jcli.main(jargv)
    real = ttrain.make_train_step

    def port_spy(*a, **kw):
        inner = real(*a, **kw)

        def step(state, batch):
            seen["port"].append({k: v.cpu().numpy() if torch.is_tensor(v)
                                 else v for k, v in batch.items()})
            return inner(state, batch)
        return step

    monkeypatch.setattr(ttrain, "make_train_step", port_spy)
    summary = vqa_mplug.main(argv)
    assert summary["step"] == 2 and all(np.isfinite(summary["losses"]))
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for got, want in zip(seen["port"], seen["jax"]):
        assert set(want) <= set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert seen["port"][0]["images"].dtype == np.uint8
    names = {p.name for p in (root / "port").iterdir()}
    assert {"mask.pt", "ckpt_final", "metrics.jsonl"} <= names
