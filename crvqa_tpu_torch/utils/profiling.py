"""Tracing and metrics sinks (counterpart of `crvqa_tpu/utils/profiling.py`).

- `trace(logdir, device)`: a `torch.profiler` session over the enclosed
  work (CPU activity, plus CUDA activity on a CUDA device), written to
  `logdir` as a Chrome trace (`chrome://tracing`, Perfetto, TensorBoard's
  profiler plugin).
- `StepTimer`: wall-clock step times with warm-up exclusion.
- `MetricsWriter`: `metrics.jsonl` (one JSON object per line, values as
  `float(v)` unrounded), mirrored into a TensorBoard event file
  (`tensorboard_dir`) and optionally wandb (the reference's
  SummaryWriter / wandb hooks, mask_trainer_Robust_VQA.py:51-82, 273-276,
  785-799).
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Iterator, Optional

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


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cpu") -> Iterator[None]:
    """A torch.profiler trace of the enclosed work into `logdir` (no-op
    when it is None). On a CUDA device the enclosed work is synchronised
    before the session stops, so its kernels are in the trace."""
    if logdir is None:
        yield
        return
    from torch.profiler import profile

    prof = profile(activities=activities(device))
    prof.start()
    try:
        yield
    finally:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        export_trace(prof, logdir)


class StepTimer:
    """Wall-clock per-step timing with warm-up exclusion; JSON-line
    report."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self, batch_size: Optional[int] = None) -> dict:
        if not self._times:
            return {"steps": 0}
        mean = sum(self._times) / len(self._times)
        out = {
            "steps": len(self._times),
            "mean_step_ms": round(mean * 1000, 3),
            "min_step_ms": round(min(self._times) * 1000, 3),
        }
        if batch_size:
            out["examples_per_sec"] = round(batch_size / mean, 2)
        return out


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
