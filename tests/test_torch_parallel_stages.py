"""`run_vqa_stage1` and `prune_debias_vqa_visualbert` with `--multihost
true` over 2 gloo ranks against the same CLI in one process, on the same
global batches (--synthetic, tiny configs, fp32), the attention-dropout
keep mask on (0.1) and hidden and classifier dropout 0.

Tolerances (fp32): logged losses rtol 1e-4; stage 1's saved parameters
atol 2 * lr * steps (Adam moves each by at most about lr a step);
VisualBERT's classifier the same and at least 99.5% of its mask.pt
entries agree; test.json has the same question ids in the same order and
at least 95% of its answers agree. Rank 1 writes nothing."""
import json

import numpy as np
import pytest
import torch

from crvqa_tpu_torch.cli import prune_debias_vqa_visualbert, run_vqa_stage1
from tests.torch_parallel_worker import (files_written, metric_lines,
                                         run_cli_ranks)

LR = 1e-3
COMMON = ["--tiny", "--synthetic", "32", "--train_batch_size", "8",
          "--eval_batch_size", "8", "--logging_steps", "2",
          "--save_steps", "4", "--dtype", "float32", "--learning_rate",
          str(LR), "--do_train", "--do_eval", "--evaluate_during_training",
          "--seed", "0", "--hidden_dropout_prob", "0",
          "--classifier_dropout", "0", "--attention_probs_dropout_prob",
          "0.1"]
CLIS = {
    "stage1": (run_vqa_stage1, "crvqa_tpu_torch.cli.run_vqa_stage1",
               ["--FT_type", "lmh", "--num_train_epochs", "2"], 8),
    "visualbert": (prune_debias_vqa_visualbert,
                   "crvqa_tpu_torch.cli.prune_debias_vqa_visualbert",
                   ["--num_train_epochs", "1"], 4),
}


@pytest.fixture(scope="module", params=sorted(CLIS))
def runs(request, tmp_path_factory):
    cli, module, extra, steps = CLIS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    one = cli.main(["--output_dir", str(root / "one"), "--device", "cpu",
                    *COMMON, *extra])
    assert one["step"] == steps
    run_cli_ranks(module, [*COMMON, *extra], root / "two")
    return request.param, root, steps


def test_two_ranks_follow_the_one_rank_losses(runs):
    _, root, steps = runs
    want = metric_lines(root / "one", "loss")
    got = metric_lines(root / "two", "loss")
    assert [s for s, _ in got] == [s for s, _ in want]
    assert want[-1][0] == steps
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)


def test_artifacts_match_and_only_rank_0_writes(runs):
    name, root, steps = runs
    one, two = root / "one", root / "two"
    assert sorted(p.name for p in two.iterdir()) == sorted(
        p.name for p in one.iterdir())
    assert files_written(str(two) + "_rank1") == []
    atol = 2 * LR * steps
    if name == "stage1":
        a = torch.load(one / "run_FTlmh_only.bin", weights_only=True)
        b = torch.load(two / "run_FTlmh_only.bin", weights_only=True)
        assert list(a) == list(b)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=atol)
    else:
        m1 = torch.load(one / "mask.pt", weights_only=True)
        m2 = torch.load(two / "mask.pt", weights_only=True)
        agree = sum(int((m1[k] == m2[k]).sum()) for k in m1)
        assert agree / sum(m.numel() for m in m1.values()) >= 0.995
        c1 = torch.load(one / "classifier4masker.bin", weights_only=True)
        c2 = torch.load(two / "classifier4masker.bin", weights_only=True)
        for k in c1:
            torch.testing.assert_close(c2[k], c1[k], rtol=0, atol=atol)
    p1 = json.load(open(one / "test.json"))
    p2 = json.load(open(two / "test.json"))
    assert [p["question_id"] for p in p2] == [p["question_id"] for p in p1]
    same = sum(a["answer"] == b["answer"] for a, b in zip(p1, p2))
    assert same / len(p1) >= 0.95
