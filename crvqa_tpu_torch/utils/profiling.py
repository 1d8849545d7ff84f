"""Tracing and metrics sinks (counterpart of `crvqa_tpu/utils/profiling.py`).

- Spans: `span(name, step)` marks one layer's work inside the program
  (the stage-2 step and its mask apply, forward, backward, gradient sync
  and optimizer; the threshold reset; `predict`'s eval step and fetch;
  the prefetch consumer's wait). Recording is off until `tracing(True)`;
  on, each span keeps a record (`SpanRecord`: name, identifier, parent,
  host times, and on the card the device time between a pair of CUDA
  events) and is a profiler annotation `crvqa.<name>`, so a profiler
  session places it on the trace's clock beside the device operations.
  `spans()` reads the records, `clear()` drops them. `--profile_dir`
  (`cli/common.ProfileWindow`) records over its window.
- Profiler sessions: `activities`, `warm_session`, `device_kernels`,
  `export_trace` (`ProfileWindow`'s Chrome trace).
- `MetricsWriter`: `metrics.jsonl` (one JSON object per line, values as
  `float(v)` unrounded), mirrored into a TensorBoard event file
  (`tensorboard_dir`) and optionally wandb (the reference's
  SummaryWriter / wandb hooks, mask_trainer_Robust_VQA.py:51-82, 273-276,
  785-799).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import time
from typing import Optional

import torch


# tiny kernels a profiler session spends before the work it keeps
WARMUP_KERNELS = 1024


def warm_session(device) -> None:
    """Launch WARMUP_KERNELS one-element kernels on `device` (a CUDA
    device; nothing elsewhere) inside a profiler session's discarded
    warm-up, and wait for them. In a process that has already run many
    kernels and profiler sessions, a new session's CUPTI can drop its
    first kernel records, on the H100 every record of a short window.
    chip_profile_sessions.py counts 2-kernel sessions after the card
    tests' full run in one process: 0 of 2 recorded in 6 of 6 sessions
    with no tiny kernels first, 2 of 2 in 5 of 6 after 64 and in 6 of 6
    after 1024. The dropped records are then these. A session can still
    come back with no device record at all (`device_kernels`)."""
    if torch.device(device).type != "cuda":
        return
    x = torch.zeros((), device=device)
    for _ in range(WARMUP_KERNELS):
        x.add_(1)
    torch.cuda.synchronize(device)


def device_kernels(prof) -> int:
    """The device (CUDA) records of a stopped profiler session."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.count for e in prof.key_averages()
               if e.device_type == cuda)


def activities(device) -> list:
    """CPU activity, plus CUDA activity when `device` is a CUDA device."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def export_trace(prof, logdir: str) -> str:
    """Write a stopped profiler session's Chrome trace into `logdir` as
    `<host>.<pid>.<ms>.pt.trace.json`; its path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "%s.%d.%d.pt.trace.json" % (
        socket.gethostname(), os.getpid(), int(time.time() * 1000)))
    prof.export_chrome_trace(path)
    return path


# ------------------------------------------------------------------ spans
# Recording is off by default: `span` then costs one test of `_ON` and
# returns `_NULL`. Spans are opened and closed on one thread (the loop
# that drives the steps); autograd's backward thread and the prefetch
# producer open none.
_ON = False
_EVENTS = False  # CUDA events at the span edges
_NULL = contextlib.nullcontext()
_RECORDS: list["SpanRecord"] = []
_OPEN: list[int] = []  # indices of the open spans, outermost first


@dataclasses.dataclass
class SpanRecord:
    """One span: `step` is the identifier every span of one unit of work
    shares (the optimizer step at a train step's entry, a batch's index
    in `predict`), `parent` the index of the enclosing span in `spans()`,
    host times from `time.perf_counter_ns()`, and `device_ms` the time
    the current CUDA stream took from the span's entry to its exit
    (resolved by `spans()`; None off the card)."""

    name: str
    step: Optional[int]
    parent: Optional[int]
    host_start_ns: int
    host_end_ns: Optional[int] = None
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


class _Span:
    """An open span: its record, a pair of CUDA events when `_EVENTS`,
    and the profiler annotation `crvqa.<name>`."""

    __slots__ = ("name", "step", "record", "mark")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step = name, step
        self.mark = torch.profiler.record_function("crvqa." + name)

    def __enter__(self) -> "SpanRecord":
        parent = _OPEN[-1] if _OPEN else None
        step = self.step if parent is None else _RECORDS[parent].step
        rec = self.record = SpanRecord(self.name, step, parent, 0)
        self.mark.__enter__()
        _OPEN.append(len(_RECORDS))
        _RECORDS.append(rec)
        if _EVENTS:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.host_start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.host_end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        if _OPEN:
            _OPEN.pop()
        self.mark.__exit__(*exc)
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager over one layer's work while recording is on
    (`tracing`): a root span takes `step` as its identifier, a span opened
    inside another takes its parent's. Off, the shared null context."""
    if not _ON:
        return _NULL
    return _Span(name, step)


def tracing(on: bool) -> None:
    """Turn span recording on or off. Where CUDA is available each span
    also records a pair of CUDA events on the current stream; nothing
    synchronises."""
    global _ON, _EVENTS
    _ON = bool(on)
    _EVENTS = _ON and torch.cuda.is_available()


def spans() -> list[SpanRecord]:
    """The records since the last `clear()`, in the order the spans
    opened, each closed span's device time resolved from its events.
    Read after a synchronisation: an event the device has not reached
    yet is waited for."""
    for rec in _RECORDS:
        if rec.events is not None and rec.host_end_ns is not None:
            start, end = rec.events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec.events = None
    return list(_RECORDS)


def clear() -> None:
    """Drop every record (the open spans' too)."""
    _RECORDS.clear()
    _OPEN.clear()


def device_ms_per_step(records: list[SpanRecord], steps: int
                       ) -> dict[str, float]:
    """`<name>_ms`: each span name's summed device ms over `steps`, for
    the names whose every record has a device time."""
    total: dict[str, float] = {}
    untimed = set()
    for rec in records:
        if rec.device_ms is None:
            untimed.add(rec.name)
        else:
            total[rec.name] = total.get(rec.name, 0.0) + rec.device_ms
    if steps <= 0:
        return {}
    return {f"{n}_ms": t / steps for n, t in total.items()
            if n not in untimed}


class MetricsWriter:
    """JSONL metrics sink. `tensorboard_dir` mirrors every float metric
    into a TensorBoard event file (`utils/tb_events.py`); `wandb_project`
    logs to wandb where the package is importable and its init succeeds,
    and otherwise prints a one-line notice and keeps the other sinks (the
    reference's is_wandb_available() gate, mask_trainer_Robust_VQA.py:
    68-82)."""

    def __init__(self, output_dir: str, name: str = "metrics.jsonl",
                 tensorboard_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None):
        self._tb = None
        self._wandb = None
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, name)
        self._fh = open(self.path, "a")
        if tensorboard_dir:
            from .tb_events import TBEventWriter

            self._tb = TBEventWriter(tensorboard_dir)
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project,
                                         dir=output_dir, resume="allow")
            except Exception as e:  # ImportError or offline init failure
                print(f"# wandb disabled ({type(e).__name__}: {e})")

    def write(self, step: int, **metrics) -> None:
        if self._fh is None:
            return
        payload = {"step": int(step)}
        for k, v in metrics.items():
            try:
                payload[k] = float(v)
            except (TypeError, ValueError):
                payload[k] = v
        self._fh.write(json.dumps(payload) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in payload.items():
                if k != "step" and isinstance(v, float):
                    self._tb.add_scalar(k, v, payload["step"])
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in payload.items() if k != "step"},
                            step=payload["step"])

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
