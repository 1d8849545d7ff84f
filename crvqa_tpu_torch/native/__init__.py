"""Native host libraries (counterpart of `crvqa_tpu/native`)."""
