"""The attention calls' roofline bounds: the least time an H100 could take
for a call, the larger of its products over the peak FLOP/s and its bytes
over the peak bandwidth.

Per call of B rows, H heads, Sq queries, Sk keys of head size D, with
activations of `e` bytes and a float32 key bias:
- forward (the primal, or the forward for a gradient): 4 * B*H*Sq*Sk*D
  FLOPs; reads q, k, v and the bias, writes the context;
- backward: 8 * B*H*Sq*Sk*D FLOPs; reads q, k, v, the bias and the
  context's gradient, writes dq, dk and dv.
Each input byte is read once and each output byte written once. What an
implementation keeps between the two (a stored probability residual, a
dropout mask) is its own choice and is not counted, so no design can
read above its bound.
"""
from __future__ import annotations


def call_cost(call: tuple, kind: str, elem: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call in `kind` 'forward' or 'backward'."""
    b, h, sq, sk, d, _ = call
    q, kv, bias = b * sq * h * d * elem, b * sk * h * d * elem, b * sk * 4
    if kind == "forward":
        return 4.0 * b * h * sq * sk * d, q + 2 * kv + bias + q
    if kind == "backward":
        reads, writes = q + 2 * kv + bias + q, q + 2 * kv
        return 8.0 * b * h * sq * sk * d, reads + writes
    raise ValueError(f"attention call kind {kind!r}")


def bound_s(calls: list, kinds: tuple[str, ...], elem: int,
            peaks: dict) -> float:
    """The summed bounds (s) of `calls`, each once per kind in `kinds`
    (a backward only for calls that have one)."""
    total = 0.0
    for call in calls:
        for kind in kinds:
            if kind == "backward" and not call[5]:
                continue
            flops, nbytes = call_cost(call, kind, elem)
            total += max(flops / peaks["bfloat16_flops"],
                         nbytes / peaks["hbm_bytes_per_s"])
    return total
