"""visual_ms.train: the device ms a training step spends in the program's
`visual_encoder` span, the visual encoder (the ViT and its adapter),
from the CUDA events at its edges (`crvqa_tpu_torch/utils/profiling.py`)
over the traced run's recorded steps. None where the program records no
such span."""


def read(run, peaks):
    return (run.counters.get("span_ms") or {}).get("visual_encoder")
