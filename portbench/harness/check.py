"""The numbers the output check compares, each a gap between what the
program produced and what the plain reference works out from the same
inputs, as a share of the reference's own scale.

Training (the first `check.steps` steps of the window's own call):
- `loss_gap`: the largest |program loss - reference loss| / |reference
  loss| over the steps;
- `grad_gap`: over the leaves (one score matrix per masked weight and
  each classifier tensor), the largest |program norm - reference norm| of
  the first step's clipped gradient as the optimizer took it, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
- `change_gap`: the same of each leaf's change over the steps, over the
  leaves whose first reference gradient is at least a thousandth of the
  median leaf's (the others move by round-off alone);
- `thr_gap`: the same of each matrix's threshold after the reset that
  follows the steps.
Answering: `logit_gap`, the largest |program logit - reference logit| of
the sampled answers over the reference logits' root mean square, and
`missing`, the answers that never came or came non-finite.
"""
from __future__ import annotations

import math
import statistics

import torch


def _worst_leaf(prog: dict, ref: dict, keys=None) -> float:
    keys = list(ref) if keys is None else list(keys)
    if set(prog) != set(ref):
        return math.inf
    median = statistics.median(abs(ref[k]) for k in keys)
    return max(abs(prog[k] - ref[k]) / max(abs(ref[k]), median, 1e-30)
               for k in keys)


def training_readings(prog: dict, ref: dict) -> dict:
    """`prog` and `ref`: {'losses': [...], 'grad': {leaf: norm},
    'change': {leaf: norm}, 'thresholds': {matrix: value}}."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {k: math.inf for k in ("loss_gap", "grad_gap", "change_gap",
                                      "thr_gap")}
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    median = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * median]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"]),
            "change_gap": _worst_leaf(prog["change"], ref["change"], moving),
            "thr_gap": _worst_leaf(prog["thresholds"], ref["thresholds"])}


def answer_readings(samples: list, ref_logits: dict, unreturned: int) -> dict:
    """`samples`: [(pool batch, row indices, program logits [n, answers])];
    `ref_logits`: pool batch -> reference logits of all its rows;
    `unreturned`: the answers sent whose logits never came back."""
    gap, sq, count, missing = 0.0, 0.0, 0, unreturned
    for j, rows, logits in samples:
        ref = ref_logits[j][rows].double()
        got = torch.as_tensor(logits).double()
        bad = ~torch.isfinite(got).all(dim=1)
        missing += int(bad.sum())
        diff = (got[~bad] - ref[~bad]).abs()
        if diff.numel():
            gap = max(gap, float(diff.max()))
        sq += float(ref.pow(2).sum())
        count += ref.numel()
    rms = math.sqrt(sq / max(count, 1))
    return {"logit_gap": gap / rms if rms > 0 else math.inf,
            "missing": float(missing)}
