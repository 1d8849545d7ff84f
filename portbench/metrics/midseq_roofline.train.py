"""midseq_roofline.train: the mid-length attention kernels' share of their
roofline in the profiled training steps, in %: the summed bounds of the
step's mid-length attention calls (those with heads * max(Sq, Sk) above
1024, as the plain reference logs them; `counts/attention.py`, a forward
and a backward per call that has one; the decoder's cross-attention at
its grouped shape, each question's memory read once) over the profiled
device time of the kernels whose names hold `midseq_` (the forward, and
the backward's dq and dk / dv kernels). None when the profile holds none
of them."""
from portbench.counts.attention import bound_s

KERNELS = ("midseq_",)
SHORT_HEADS_TIMES_SEQ = 1024


def read(run, peaks):
    if not peaks or not run.profile or not run.profile["window"]:
        return None
    lo, hi = run.profile["window"]
    spent = sum(dur for name, ts, dur in run.profile["ops"]
                if any(k in name for k in KERNELS) and lo <= ts < hi) / 1e6
    if spent <= 0:
        return None
    calls = [c for c in run.counters["attention_calls"]
             if c[1] * max(c[2], c[3]) > SHORT_HEADS_TIMES_SEQ]
    elem = 2 if run.cfg["dtype"] == "bfloat16" else 4
    bound = run.counters["profiled_steps"] * bound_s(
        calls, ("forward", "backward"), elem, peaks)
    return 100.0 * bound / spent
