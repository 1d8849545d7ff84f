"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU: the CPU path exists for
tests, and a measurement taken there would be mistaken for the card's.
"""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """`"cuda"` (default) or `"cuda:N"` -> that card, raising if absent;
    `"cpu"` -> the CPU, only when asked for by name. Under a process group
    (`parallel.initialize_multihost`) a bare `"cuda"` is this process's
    own card, `cuda:{LOCAL_RANK}`."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU on purpose")
    if dev.index is None and torch.distributed.is_initialized():
        from .parallel.mesh import local_rank

        dev = torch.device("cuda", local_rank())
    return dev
