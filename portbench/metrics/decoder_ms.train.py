"""decoder_ms.train: the device ms a training step spends in the program's
`decoder` span, the answer decoder, the LM head and the loss, from the
CUDA events at its edges (`crvqa_tpu_torch/utils/profiling.py`) over the
traced run's recorded steps. None where the program records no such
span."""


def read(run, peaks):
    return (run.counters.get("span_ms") or {}).get("decoder")
