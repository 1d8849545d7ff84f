"""`vqa_mplug --mode mask` with `--multihost true` over 2 gloo ranks against
the same CLI in one process, on the same global batches (--synthetic,
tiny mPLUG, fp32, every dropout 0: at these widths the ViT's attention is
on the eager path, whose masks are each data rank's own), with the default
`--opt adamw` and with `--opt lamb` (a per-leaf trust ratio) and `--opt
adafactor` (factored second moments): the optimizer state is ZeRO-sharded
by whole leaves on both ranks, as the CLI always shards it.

Tolerances (fp32): logged losses rtol 1e-4; the final checkpoint's scores
and LM head atol 2 * max(lr) * steps; at least 99.5% of the mask.pt
entries agree; vqa_result.json answers the same question ids in the same
order, at least 90% of the answers alike (beam search over a random tiny
model). Rank 1 writes nothing. The three 2-rank runs share one spawn of
the ranks."""
import json

import numpy as np
import pytest
import torch

from crvqa_tpu_torch.cli import vqa_mplug
from tests.torch_parallel_worker import (files_written, metric_lines,
                                         run_clis_ranks)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

STEPS = 8  # 16 examples / 4 x 2 epochs
ARGS = ["--tiny", "--dtype", "float32", "--synthetic", "16",
        "--train_batch_size", "4", "--eval_batch_size", "4",
        "--num_train_epochs", "2", "--masker_update_step", "2",
        "--logging_steps", "2", "--save_steps", "100", "--init_sparsity",
        "0.3", "--final_sparsity_epoch", "1", "--seed", "3",
        "--hidden_dropout_prob", "0", "--attention_probs_dropout_prob", "0",
        "--beam_size", "2", "--do_train", "--do_eval"]


OPTS = ["adamw", "lamb", "adafactor"]


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """Each optimizer's one-process run, then their 2-rank runs in one
    spawn of the ranks."""
    roots, ones = {}, {}
    for opt in OPTS:
        roots[opt] = tmp_path_factory.mktemp(opt)
        ones[opt] = vqa_mplug.main(["--output_dir", str(roots[opt] / "one"),
                                    "--device", "cpu", *ARGS, "--opt", opt])
        assert ones[opt]["step"] == STEPS
    run_clis_ranks([("crvqa_tpu_torch.cli.vqa_mplug", [*ARGS, "--opt", opt],
                     roots[opt] / "two") for opt in OPTS])
    return roots, ones


@pytest.fixture(scope="module", params=OPTS)
def runs(request, all_runs):
    roots, ones = all_runs
    return roots[request.param], ones[request.param]


def test_two_ranks_follow_the_one_rank_run(runs):
    root, one = runs
    want = metric_lines(root / "one", "loss")
    got = metric_lines(root / "two", "loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6, 8]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    assert metric_lines(root / "two", "sparsity") == pytest.approx(
        metric_lines(root / "one", "sparsity"), abs=1e-3)
    raw1 = torch.load(root / "one" / "ckpt_final", weights_only=True)
    raw2 = torch.load(root / "two" / "ckpt_final", weights_only=True)
    atol = 2 * 3e-5 * STEPS  # lr1, the larger of the two groups' rates
    for part in ("scores", "params"):
        assert list(raw2[part]) == list(raw1[part])
        for k in raw1[part]:
            torch.testing.assert_close(raw2[part][k], raw1[part][k], rtol=0,
                                       atol=atol)
    # the checkpoint carries the whole (gathered) optimizer state
    assert raw2["opt_state"].keys() == raw1["opt_state"].keys()


def test_artifacts_match_and_only_rank_0_writes(runs):
    root, _ = runs
    one, two = root / "one", root / "two"
    assert sorted(p.name for p in two.iterdir()) == sorted(
        p.name for p in one.iterdir())
    assert files_written(str(two) + "_rank1") == []
    m1 = torch.load(one / "mask.pt", weights_only=True)
    m2 = torch.load(two / "mask.pt", weights_only=True)
    agree = sum(int((m1[k] == m2[k]).sum()) for k in m1)
    assert agree / sum(m.numel() for m in m1.values()) >= 0.995
    r1 = json.load(open(one / "vqa_result.json"))
    r2 = json.load(open(two / "vqa_result.json"))
    assert [r["question_id"] for r in r2] == [r["question_id"] for r in r1]
    same = sum(a["answer"] == b["answer"] for a, b in zip(r1, r2))
    assert same / len(r1) >= 0.9
