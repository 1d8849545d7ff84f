"""The benchmark's profile (`harness/trace.profile`) of work that opens
the program's spans (`crvqa_tpu_torch.utils.profiling.span`) with their
recording on: the same keys, its own annotations and window as with it
off. The program's `crvqa.*` annotations stay out of `marks`, so
`breakdown()` lays idle gaps by the benchmark's spans alone."""
from __future__ import annotations

import torch

from portbench.harness.trace import profile


def test_profile_keeps_ops_marks_and_window_with_program_spans_open():
    from crvqa_tpu_torch.utils import profiling

    def work():
        with profiling.span("train_step", 0):
            with profiling.span("forward"):
                torch.ones(8).sum()

    out = {}
    try:
        for on in (False, True):
            profiling.tracing(on)
            out[on] = profile(work, work, "cpu")
        assert [r.name for r in profiling.spans()] == [
            "train_step", "forward"] * 2  # the warm session's and the kept
    finally:
        profiling.tracing(False)
        profiling.clear()
    for prof in out.values():
        assert set(prof) == {"ops", "marks", "window"}
        assert [m[0] for m in prof["marks"]] == ["window"]
        lo, hi = prof["window"]
        assert hi > lo and prof["ops"] == []
