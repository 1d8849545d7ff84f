"""Mask tables and pruning (counterpart of `crvqa_tpu/masking`)."""
