"""One run of one cell: look the cell up, run its driver, read the
per-layer metrics of a traced run, judge the outputs and build the result
line.

A driver's `run(run)` sets up the program, warms up, measures the window
and checks the outputs, filling the `Run` it is given: `e2e` (end-to-end
values by metric name), `counters` (what the per-layer readers read),
`profile` (the device profile of a traced run), `attempted` / `failed`,
`readings` (each number compared with the reference) and the memory
peaks. Forbidden modules, the chip count and the printing are
`main.py`'s.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from . import cells, trace


@dataclasses.dataclass
class Run:
    bench: cells.Benchmark
    cell: dict
    cfg: dict
    trf: dict
    family: object
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t0: float  # the process's start on the host clock
    limits: dict
    spans: trace.Spans = None
    e2e: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    profile: Optional[dict] = None
    attempted: int = 0
    failed: int = 0
    readings: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0

    def __post_init__(self):
        if self.spans is None:
            self.spans = trace.Spans(self.traced, self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()

    def reset_peak(self) -> None:
        """The peak so far into `memory_peak_bytes`; the counter starts
        again (the window's own peak follows)."""
        self.memory_peak_bytes = max(self.memory_peak_bytes, self.peak())
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """(every number that has a limit read, finite and at or under it,
    [(name, reading, limit)] in the limits' order). A reading with no
    limit is not compared (PERF.md names each, with its readings)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        ok &= math.isfinite(value) and value <= limit
        rows.append((name, value, limit))
    return bool(ok), rows


def peaks(bench: cells.Benchmark, device_name: str) -> dict:
    import json
    import os

    with open(os.path.join(bench.dir, "counts", "peaks.json")) as f:
        table = json.load(f)
    if table["card"] != device_name:
        raise RuntimeError(f"counts/peaks.json holds the peaks of "
                           f"{table['card']!r}, not of {device_name!r}")
    return table


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def setup_split(run: Run) -> str:
    """Where `setup_s` went: the process's start up to the first set-up
    span (imports, the CUDA context), then each set-up span."""
    items = [(n, a, b) for n, a, b in run.spans.items
             if n.startswith(("setup_", "check_", "warmup"))]
    if not items:
        return ""
    parts = [f"start {items[0][1] - run.t0:.3f}"]
    parts += [f"{n} {b - a:.3f}" for n, a, b in items]
    return "setup (s): " + ", ".join(parts)


def run_cell(bench: cells.Benchmark, workload: str, seed: int,
             seconds: float, traced: bool, device, t0: float,
             overrides: Optional[dict] = None,
             report=None) -> tuple[dict, list]:
    """Run `workload` once; returns (the result line's object, the checked
    numbers [(name, reading, limit)]). `overrides` ({'config': {...},
    'traffic': {...}, 'limits': {...}}) replace entries of the cell's files
    (the tests' tiny presets). `report`: a file for the set-up split."""
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    trf = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    for part, target in (("config", cfg), ("traffic", trf),
                         ("limits", limits)):
        target.update((overrides or {}).get(part, {}))
    dev = torch.device(device)
    run = Run(bench, cell, cfg, trf, cells.family(cfg), seed, seconds, traced,
              dev, t0, limits)
    cells.driver(trf).run(run)
    if report is not None:
        print(setup_split(run), file=report)
    correct, rows = judge(run.readings, limits)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    name = device_name(dev)
    for m in bench.metrics(workload, kind):
        if traced:
            value = bench.reader(m["name"]).read(run, peaks(bench, name)
                                                 if dev.type == "cuda"
                                                 else None)
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": name, "count": 1,
                "memory_peak_bytes": run.memory_peak_bytes}
    if traced:
        bw = trace.busy_window_s(run.profile)
        dev_info["busy_s"], dev_info["window_s"] = bw if bw else (0.0, 0.0)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev_info}
    if traced:
        bd = trace.breakdown(run.profile)
        if bd:
            out["breakdown"] = bd
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out, rows
