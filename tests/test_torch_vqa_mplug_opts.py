"""The port's mPLUG trainer with every `--opt` kind and `--use_checkpoint`
(AdaHessian with it and `--distill`), on `--synthetic` batches: each run
trains, evaluates and writes its checkpoint. Split from
tests/test_torch_vqa_mplug.py (its `_argv`) so that each file is a short
job for one test worker.
"""
import numpy as np
import pytest

from crvqa_tpu_torch.cli import vqa_mplug
from tests.test_torch_vqa_mplug import _argv
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("extra", [
    ["--opt", "adahessian"], ["--opt", "lookahead_lamb"],
    ["--opt", "adamp", "--mode", "full"], ["--opt", "sgdp"],
    ["--use_checkpoint", "true"],
    ["--use_checkpoint", "true", "--opt", "adahessian", "--distill", "true"]],
    ids=lambda e: "_".join(x.strip("-") for x in e))
def test_opts_and_checkpointing_train(tmp_path, extra):
    """The flags that raised before this slice run the CLI end to end:
    finite losses, the artifacts, a resume from their own checkpoint (the
    optimizer's state restored by field)."""
    summary = vqa_mplug.main(_argv(tmp_path, [
        "--do_train", "--num_train_epochs", "1", *extra]))
    assert summary["step"] == 4 and all(np.isfinite(summary["losses"]))
    assert (tmp_path / "ckpt_final").exists()
    again = vqa_mplug.main(_argv(tmp_path / "again", [
        "--do_train", "--num_train_epochs", "1", "--resume_from",
        str(tmp_path / "ckpt_3"), *extra]))
    assert again["step"] == 3 + 4
