"""MFU accounting for the port (counterpart of `crvqa_tpu/utils/mfu.py`):
the FLOPs of one call of a step, counted by torch's dispatcher, over the
card's dense peak.

The JAX package reads its FLOPs from XLA's cost analysis of the compiled
executable (`compiled_flops`, `lowered_flops`). Torch has no compiled
executable to read, so `compiled_flops` has no counterpart here: the
counterpart of `lowered_flops` is `count_flops`, which runs the call once
under `torch.utils.flop_counter.FlopCounterMode` on the `meta` device. The
count is the dispatcher's, not hand-derived, and it costs no device memory
and no device time.

On the card the attention and matmul kernels are ctypes launches
(`ops/_build.py`), which the dispatcher never sees. On `meta` tensors every
kernel wrapper takes its plain version, as on CPU tensors, so the count is
the model's work whatever implements it: a kernel's own recompute or
padding never enters it. Attention counts 4 * B*H*Sq*Sk*D forward and 8
backward (autograd of the plain forward, whatever `BWD_IMPL` the card
runs), a matmul 2*M*K*N. Elementwise work (softmax, norms, the optimizer,
mask application) is not counted: `FlopCounterMode` counts the products.

A call counts on `meta` only if it reads no value back on the host
(`.item()`), takes no shape from the data and draws from no generator
bound to a device (generators are replaced by CPU ones, which `meta` draws
take). Every path `chip_smoke.py` times does: the training steps, the
LXMERT and VisualBERT forwards, and mPLUG's beam search and answer
ranking, whose loops have fixed trip counts and whose top-k has a fixed k
(the ranking's answer list follows its batch's device for this). FLOPs
are linear in the batch (tests/test_torch_mfu.py), so a call that could
not would be counted at batch 1 on the CPU and scaled.

`chip_smoke.py` prints each timed path's `flops_per_step`, `mfu` against
the wall step and `busy_mfu` against the profiled busy time.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# Dense (no sparsity) peak FLOP/s of NVIDIA's H100 cards by the name
# `torch.cuda.get_device_name()` gives, from NVIDIA's H100 Tensor Core GPU
# datasheet: bf16 / fp16 on the tensor cores, fp32 outside them (no TF32).
# The datasheet gives the tensor-core rates with sparsity; dense is half.
PEAK_FLOPS = (
    ("h100 nvl", {"bfloat16": 835e12, "float32": 60e12}),
    ("h100 pcie", {"bfloat16": 756e12, "float32": 51e12}),
    ("h100 80gb hbm3", {"bfloat16": 989e12, "float32": 67e12}),  # SXM5
)
_RATE = {torch.bfloat16: "bfloat16", torch.float16: "bfloat16",
         torch.float32: "float32"}


def peak_flops(device_name: str, dtype: torch.dtype = torch.bfloat16
               ) -> float:
    """The card's dense peak FLOP/s for products in `dtype` (bf16 and fp16
    on the tensor cores, fp32 outside them). An unknown card or dtype
    raises: no peak is guessed."""
    if dtype not in _RATE:
        raise ValueError(f"peak_flops: no peak for {dtype} (bfloat16, "
                         f"float16 or float32)")
    name = device_name.lower()
    for key, peaks in PEAK_FLOPS:
        if key in name:
            return peaks[_RATE[dtype]]
    raise ValueError(f"peak_flops: no peak known for the card "
                     f"{device_name!r} (known: "
                     f"{', '.join(k for k, _ in PEAK_FLOPS)})")


def _to(obj: Any, device: str, memo: dict) -> Any:
    """`obj` with every tensor on `device` (requires_grad kept) and every
    generator a CPU one seeded alike (random draws on `meta` tensors take
    a CPU generator); containers and dataclasses are copied, anything else
    is shared."""
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.detach().to(device)
        if obj.requires_grad:
            out.requires_grad_(True)
    elif isinstance(obj, torch.Generator):
        out = torch.Generator().manual_seed(obj.initial_seed())
    elif isinstance(obj, dict):
        out = type(obj)((k, _to(v, device, memo)) for k, v in obj.items())
    elif isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        out = type(obj)(_to(v, device, memo) for v in obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name,
                               _to(getattr(obj, f.name), device, memo))
    else:
        out = obj
    memo[id(obj)] = out
    return out


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """The FLOPs of one call `fn(*args, **kwargs)`, counted by
    `FlopCounterMode` with every tensor of the arguments (in dicts, lists,
    tuples and dataclasses, a training state included) copied to the
    `meta` device. The arguments themselves are left as they are: a step
    that updates its state in place updates the copy. `fn` may close over
    a meta model (`functional_call`) or take its parameters as an
    argument; a backward inside `fn` counts."""
    memo: dict = {}
    args = _to(args, "meta", memo)
    kwargs = _to(kwargs, "meta", memo)
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def mfu(flops_per_call: float, calls: int, seconds: float, device_name: str,
        dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """Counted FLOPs over the time they took over the card's peak (the
    JAX package's math). None when the FLOPs are unknown (0) or no time
    was measured."""
    if not flops_per_call or seconds <= 0:
        return None
    return (flops_per_call * calls / seconds) / peak_flops(device_name,
                                                           dtype)
