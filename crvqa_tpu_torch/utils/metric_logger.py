"""Windowed metric smoothing and logging (counterpart of
`crvqa_tpu/utils/metric_logger.py`; the reference's
`mPLUG/utils.py:SmoothedValue` / `MetricLogger`, :11-165).

Host-side Python: values are floats, a tensor is read with `float()`.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Iterable, Iterator


class SmoothedValue:
    """A window of the last `window_size` values and the running total
    of every value: median (the LOWER median of an even window, as
    torch.median gives, mPLUG/utils.py:43-45), avg, max and value over the
    window, global_avg over all; each 0.0 while empty."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[(len(d) - 1) // 2] if d else 0.0

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    """Named `SmoothedValue` meters (made on first update; assign
    `meters[name]` for another window or format), printed as
    "name: meter" joined by `delimiter`."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self) -> None:
        """A no-op, as in the JAX package. The reference all-reduces each
        meter's count and total here; the port's train steps already
        return metrics reduced over the data group
        (`train.common.reduce_metrics`), so every process logs the global
        values."""

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "") -> Iterator:
        """Yield from `iterable`, printing the meters and the mean time a
        consumer took per item every `print_freq` items, then the total
        time."""
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for i, obj in enumerate(iterable):
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0:
                print(f"{header} [{i}] {self} time: {iter_time}", flush=True)
        total = time.time() - start
        print(f"{header} Total time: {total:.1f}s", flush=True)
