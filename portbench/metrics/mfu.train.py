"""mfu.train: the model's FLOPs per step (the benchmark's own count on its
plain reference, `counts/flops.py`) times the steps of the traced window
outside its profiled steps, over those seconds, over the card's dense
bf16 peak (`counts/peaks.json`), in %."""


def read(run, peaks):
    c = run.counters
    if not peaks or not c.get("window_s") or not c.get("steps"):
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / c["window_s"] / peaks[
        "bfloat16_flops"]
