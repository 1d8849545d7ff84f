"""Checkpoint and artifact interop (counterpart of `crvqa_tpu/core`)."""
