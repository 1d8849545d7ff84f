"""Host data pipeline (counterpart of `crvqa_tpu/data`)."""
