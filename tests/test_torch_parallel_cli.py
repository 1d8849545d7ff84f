"""`prune_debias_vqa --multihost true --zero_opt true` over 2 gloo ranks
against the same CLI in one process, on the same global batches
(--synthetic, tiny LXMERT, fp32), with the attention-dropout keep mask ON
(0.1) and hidden and classifier dropout 0: the attention kernels' masks
are keyed on the global batch row (`row0`), so the two runs draw the same
masks and differ only by the order of fp32 sums. The same for
`--mesh_model 2` (tensor parallelism: the masks keyed on each rank's
first head, `head0`). Then a world-1 resume of the 2-rank ZeRO
checkpoint.

Tolerances (fp32, as tests/test_torch_stage2.py): logged losses rtol 1e-4
(a wrong row offset moves them by ~1e-2); classifier atol 2 * lr * steps;
at least 99.5% of the mask.pt entries agree; test.json has the same
question ids in the same order and at least 95% of its answers agree.
Rank 1 writes nothing. The resumed state equals the checkpoint's leaves
bit for bit, the ZeRO-gathered moments included. The two 2-rank runs
share one spawn of the ranks."""
import json

import numpy as np
import pytest
import torch

from crvqa_tpu_torch.cli import prune_debias_vqa
from tests.torch_parallel_worker import (files_written, metric_lines,
                                         run_clis_ranks)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

LR = 1e-3
STEPS = 8  # 32 examples / 8 x 2 epochs
ARGS = ["--tiny", "--synthetic", "32", "--train_batch_size", "8",
        "--eval_batch_size", "8", "--num_train_epochs", "2",
        "--logging_steps", "2", "--save_steps", "4", "--dtype", "float32",
        "--learning_rate", str(LR), "--do_train", "--do_eval",
        "--evaluate_during_training", "--seed", "0", "--Masker_type", "lmh",
        "--hidden_dropout_prob", "0", "--classifier_dropout", "0",
        "--attention_probs_dropout_prob", "0.1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2dp")
    one = prune_debias_vqa.main(["--output_dir", str(root / "one"),
                                 "--device", "cpu", *ARGS])
    run_clis_ranks([
        ("crvqa_tpu_torch.cli.prune_debias_vqa", [*ARGS, "--zero_opt", "true"],
         root / "two"),
        ("crvqa_tpu_torch.cli.prune_debias_vqa", [*ARGS, "--mesh_model", "2"],
         root / "tp")])
    return root, one


def test_two_ranks_follow_the_one_rank_losses(runs):
    root, one = runs
    assert one["step"] == STEPS
    want = metric_lines(root / "one", "loss")
    got = metric_lines(root / "two", "loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6, 8]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    np.testing.assert_allclose(
        [v for _, v in metric_lines(root / "two", "eval_acc")],
        [v for _, v in metric_lines(root / "one", "eval_acc")], atol=5.0)


def test_artifacts_match_and_only_rank_0_writes(runs):
    root, _ = runs
    one, two = root / "one", root / "two"
    names = lambda d: sorted(p.name for p in d.iterdir())
    assert names(two) == names(one)
    assert files_written(str(two) + "_rank1") == []
    m1 = torch.load(one / "mask.pt", weights_only=True)
    m2 = torch.load(two / "mask.pt", weights_only=True)
    assert list(m1) == list(m2)
    agree = sum(int((m1[k] == m2[k]).sum()) for k in m1)
    assert agree / sum(m.numel() for m in m1.values()) >= 0.995
    c1 = torch.load(one / "classifier4masker.bin", weights_only=True)
    c2 = torch.load(two / "classifier4masker.bin", weights_only=True)
    for k in c1:
        torch.testing.assert_close(c2[k], c1[k], rtol=0,
                                   atol=2 * LR * STEPS)
    p1 = json.load(open(one / "test.json"))
    p2 = json.load(open(two / "test.json"))
    assert [p["question_id"] for p in p2] == [p["question_id"] for p in p1]
    same = sum(a["answer"] == b["answer"] for a, b in zip(p1, p2))
    assert same / len(p1) >= 0.95


def test_tensor_parallel_ranks_follow_the_one_rank_run(runs):
    """--mesh_model 2: each rank runs half of every attention's heads (the
    kernels keyed on its first head, `head0`) and FFN's units; the logged
    losses, the masks and the classifier are the one-rank run's (the same
    tolerances), the checkpoint holds whole leaves, rank 1 writes
    nothing."""
    root, _ = runs
    one, tp = root / "one", root / "tp"
    want, got = (metric_lines(one, "loss"), metric_lines(tp, "loss"))
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    assert files_written(str(tp) + "_rank1") == []
    m1 = torch.load(one / "mask.pt", weights_only=True)
    m2 = torch.load(tp / "mask.pt", weights_only=True)
    agree = sum(int((m1[k] == m2[k]).sum()) for k in m1)
    assert agree / sum(m.numel() for m in m1.values()) >= 0.995
    c1 = torch.load(one / "ckpt_8", weights_only=True)
    c2 = torch.load(tp / "ckpt_8", weights_only=True)
    for k in c1["scores"]:
        torch.testing.assert_close(c2["scores"][k], c1["scores"][k], rtol=0,
                                   atol=2 * LR * STEPS)
    mu1, mu2 = c1["opt_state"]["mu"], c2["opt_state"]["mu"]
    assert {k: v.shape for k, v in mu2.items()} == {
        k: v.shape for k, v in mu1.items()}


def test_world_one_resumes_the_two_rank_zero_checkpoint(runs, tmp_path):
    root, _ = runs
    path = root / "two" / "ckpt_4"
    raw = torch.load(path, weights_only=True)
    loaded = prune_debias_vqa.main([
        "--output_dir", str(tmp_path / "load"), "--device", "cpu", *ARGS,
        "--num_train_epochs", "0", "--resume_from", str(path)])["state"]
    assert loaded.step == raw["step"] == 4
    opt = loaded.opt_state
    for part, got in (("scores", loaded.scores), ("mu", opt.mu),
                      ("nu", opt.nu)):
        want = raw["opt_state"][part] if part in ("mu", "nu") else raw[part]
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k].detach(), want[k]), (part, k)
    on = prune_debias_vqa.main([
        "--output_dir", str(tmp_path / "on"), "--device", "cpu", *ARGS,
        "--num_train_epochs", "1", "--resume_from", str(path)])
    assert on["step"] == 8 and np.isfinite(on["losses"]).all()
