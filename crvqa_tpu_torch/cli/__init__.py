"""Command-line entry points (counterpart of `crvqa_tpu/cli`)."""
