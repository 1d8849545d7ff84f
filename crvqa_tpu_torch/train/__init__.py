"""Training (counterpart of `crvqa_tpu/train`): the stage-2 mask-training
step, its optimizer and evaluation."""
