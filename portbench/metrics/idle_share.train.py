"""idle_share.train: the share (%) of the profiled training steps' window
in which no operation ran on the device (the union of the profile's
device operations, `harness/trace.py`)."""
from portbench.harness.trace import busy_window_s


def read(run, peaks):
    bw = busy_window_s(run.profile)
    return None if bw is None else 100.0 * (1.0 - bw[0] / bw[1])
