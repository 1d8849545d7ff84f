"""The benchmark's own tracing: host spans around its calls into the
program, and a device profile of a short sub-window read back from the
profiler's Chrome trace.

A span is (name, start s, end s) on the host clock; in a traced run each
is also a profiler annotation `portbench.<name>`, so an idle gap on the
device can be laid to what the host was doing. The profile keeps every
device operation (kernels, copies, sets) and every annotation, in the
trace's microseconds, and the annotated window `portbench.window`.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WARM_KERNELS = 1024


class Spans:
    """Host spans of one run. `sync`: synchronise the device before and
    after, so the span holds the device's work too."""

    def __init__(self, traced: bool, device):
        self.traced, self.device = traced, torch.device(device)
        self.items: list[tuple[str, float, float]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        if sync:
            self._sync()
        t0 = time.perf_counter()
        mark = (torch.profiler.record_function(f"portbench.{name}")
                if self.traced else contextlib.nullcontext())
        with mark:
            yield
            if sync:
                self._sync()
        self.items.append((name, t0, time.perf_counter()))

    def named(self, name: str) -> list[float]:
        """The durations (s) of the spans called `name`."""
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


def _session(fn: Callable[[], None], dev: torch.device, window: bool):
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        if dev.type == "cuda":
            x = torch.zeros((), device=dev)
            for _ in range(WARM_KERNELS):
                x.add_(1)
            torch.cuda.synchronize(dev)
        mark = (record_function("portbench.window") if window
                else contextlib.nullcontext())
        with mark:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return prof


def profile(warm: Callable[[], None], fn: Callable[[], None],
            device) -> dict:
    """Run `warm` in a discarded profiler session, then `fn` in the kept
    one, each between two synchronisations and after WARM_KERNELS
    one-element kernels: a process's first session stalls the host while
    the profiler starts, and a fresh session can drop its first device
    records. Returns the kept session's device operations [(name, ts,
    dur)], its annotations [(name, ts, dur)] and the window (ts, end) of
    `portbench.window`, in microseconds."""
    dev = torch.device(device)
    _session(warm, dev, False)
    prof = _session(fn, dev, True)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    ops, marks = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATEGORIES:
            ops.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith("portbench.")):
            marks.append((e["name"][len("portbench."):], float(e["ts"]),
                          float(e["dur"])))
    win = [m for m in marks if m[0] == "window"]
    window = (win[0][1], win[0][1] + win[0][2]) if win else None
    return {"ops": ops, "marks": marks, "window": window}


def _clipped(prof: dict) -> list[tuple[float, float]]:
    """The device operations' intervals inside the window, sorted."""
    lo, hi = prof["window"]
    out = [(max(ts, lo), min(ts + dur, hi)) for _, ts, dur in prof["ops"]]
    return sorted((a, b) for a, b in out if b > a)


def busy_intervals(prof: dict) -> list[tuple[float, float]]:
    """The union of the device operations' intervals in the window."""
    merged: list[list[float]] = []
    for a, b in _clipped(prof):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_window_s(prof: Optional[dict]) -> Optional[tuple[float, float]]:
    """(seconds some device operation ran, the window's seconds), or None
    when the profile holds no device operation."""
    if not prof or not prof["window"] or not prof["ops"]:
        return None
    busy = sum(b - a for a, b in busy_intervals(prof))
    if busy <= 0:
        return None
    lo, hi = prof["window"]
    return busy / 1e6, (hi - lo) / 1e6


def breakdown(prof: Optional[dict], top: int = 10) -> Optional[dict]:
    """The device operations that took most time, and the idle gaps summed
    by the innermost host span open when each began ('between_spans'
    where none but the window was)."""
    if busy_window_s(prof) is None:
        return None
    by_name: dict[str, float] = {}
    lo, hi = prof["window"]
    for name, ts, dur in prof["ops"]:
        d = min(ts + dur, hi) - max(ts, lo)
        if d > 0:
            by_name[name[:96]] = by_name.get(name[:96], 0.0) + d / 1e6
    marks = sorted((m for m in prof["marks"] if m[0] != "window"),
                   key=lambda m: m[1])
    gaps: dict[str, float] = {}
    edge = lo
    for a, b in busy_intervals(prof) + [(hi, hi)]:
        if a > edge:
            owner = "between_spans"
            for name, ts, dur in marks:
                if ts <= edge < ts + dur:
                    owner = name  # the latest opened that still holds
            gaps[owner] = gaps.get(owner, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}
