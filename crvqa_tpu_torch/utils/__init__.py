"""Observability: trace, metrics and TensorBoard sinks (counterpart of
`crvqa_tpu/utils`)."""
