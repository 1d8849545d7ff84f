"""`mask.pt` of the port's mPLUG trainer against the JAX CLI's, one argv on
both sides: the same keys and shapes. Split from
tests/test_torch_vqa_mplug.py (its `_argv`) so that the two JAX CLI runs
are a job of their own for one test worker.
"""
import pytest
import torch

from crvqa_tpu_torch.cli import vqa_mplug
from tests.test_torch_vqa_mplug import _argv
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


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
