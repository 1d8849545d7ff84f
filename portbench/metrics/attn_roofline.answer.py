"""attn_roofline.answer: the short attention kernels' share of their
roofline in the profiled answering chunk, in %: the summed bounds of the
model's attention calls of its batches (`counts/attention.py`, forward
only) over the profiled device time of the kernels named here. None when
the profile holds none of them."""
from portbench.counts.attention import bound_s

# profiler names of the kernels whose time the bound is held against
KERNELS = ("fused_attention_fwd",)


def read(run, peaks):
    if not peaks or not run.profile or not run.profile["window"]:
        return None
    lo, hi = run.profile["window"]
    spent = sum(dur for name, ts, dur in run.profile["ops"]
                if any(k in name for k in KERNELS) and lo <= ts < hi) / 1e6
    if spent <= 0:
        return None
    elem = 2 if run.cfg["dtype"] == "bfloat16" else 4
    bound = run.counters["profiled_steps"] * bound_s(
        run.counters["attention_calls"], ("forward",), elem, peaks)
    return 100.0 * bound / spent
