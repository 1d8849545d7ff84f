"""Background batch preparation and host-to-device transfer (counterpart
of `crvqa_tpu/data/prefetch.py`; the overlap the reference gets from
`DataLoader(num_workers=...)`).

One producer thread runs the numpy batch iterator (feature gather and the
optional bf16 cast release the GIL), copies each batch into pinned host
memory and starts its copy to the device on a side stream with
`non_blocking=True`; the consumer waits for that copy's event before it
uses the batch (the `data_wait` span holds the queue's wait and that
one). Batch order is kept: it is part of the training contract.
Integer question ids (`question_id`, mPLUG's `qid`) and the `valid` flags
stay numpy (host-consumed).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils.profiling import span

_END = object()
HOST_KEYS = ("question_id", "qid", "valid")
# token ids and label indices: int64 on the device
LONG_KEYS = ("input_ids", "max_label", "question_ids", "answer_ids")
# visual inputs the first matmul casts to the model dtype anyway: casting
# them on the host first halves their transfer under a bf16 model
CAST_KEYS = ("visual_feats", "visual_pos")


def to_device(batch: dict, device: torch.device,
              stream: Optional[torch.cuda.Stream] = None,
              float_dtype: Optional[torch.dtype] = None) -> dict:
    """numpy batch -> tensors on `device` (int ids as int64; the visual
    inputs cast to `float_dtype` when given); host-only keys stay numpy. On
    a CUDA device the copies come from pinned memory and do not block."""
    out = {}
    for k, v in batch.items():
        if k in HOST_KEYS or not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in LONG_KEYS:
            t = t.long()
        elif k in CAST_KEYS and float_dtype is not None:
            t = t.to(float_dtype)
        if device.type == "cuda":
            t = t.pin_memory()
            with torch.cuda.stream(stream or torch.cuda.current_stream(
                    device)):
                out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def prefetch_batches(src: Iterable[dict], device: torch.device,
                     depth: int = 2,
                     float_dtype: Optional[torch.dtype] = None
                     ) -> Iterator[dict]:
    """Yield `src`'s batches as device tensors, prepared `depth` ahead on a
    producer thread. Exceptions in `src` re-raise at the consumer's next
    pull; a consumer that stops early shuts the producer down. depth <= 0
    converts inline."""
    if depth <= 0:
        for batch in src:
            yield to_device(batch, device, float_dtype=float_dtype)
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put_until_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch in src:
                event = None
                out = to_device(batch, device, side, float_dtype)
                if side is not None:
                    event = torch.cuda.Event()
                    event.record(side)
                if not put_until_stop((out, event, None)):
                    return
            tail = (_END, None, None)
        except BaseException as e:  # re-raised at the consumer
            tail = (_END, None, e)
        put_until_stop(tail)

    t = threading.Thread(target=produce, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            with span("data_wait"):
                batch, event, err = q.get()
                if event is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(stream)
            if batch is _END:
                if err is not None:
                    raise err
                return
            yield batch
    finally:
        stop.set()
        t.join(timeout=5.0)
