"""mfu.answer: the model's FLOPs per batch of the eval forward (the
benchmark's own count, `counts/flops.py`) times the batches of the traced
window outside its profiled chunk, over those seconds, over the card's
dense bf16 peak (`counts/peaks.json`), in %."""


def read(run, peaks):
    c = run.counters
    if not peaks or not c.get("window_s") or not c.get("batches"):
        return None
    return 100.0 * c["flops_per_batch"] * c["batches"] / c["window_s"] / (
        peaks["bfloat16_flops"])
