"""The output check refuses what it must, at a size a test run holds: the
control (the plain reference in float8, in the program's place) and the
program with its timed path broken underneath, each judged by the cell's
own limits (`limits/<workload>.json`, set from readings on the card at
the cells' sizes; PERF.md gives them).

Faults: a step that leaves its state unchanged; half of every batch left
out of the step, the mean taken over the rest; an answer altered where it
is produced; half of every batch's answers left out. The cells run on one
card, so no exchange between cards can be left out."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import cells
from portbench.harness.cells import Benchmark
from portbench.harness.check import answer_readings, training_readings
from portbench.harness.core import Run, judge
from portbench.reference.common import Precision
from portbench.tests.tiny import SEED, overrides, run_tiny

TRAINING = ["lxmert-stage2-b2048", "visualbert-stage2-b2048"]
ANSWERING = ["lxmert-answer-b2048"]


# the control's size: twice the tiny width, where float8's rounding shows
# as it does at the cells' own widths (the tiny preset's 32 wide hides it
# in the answering cell)
CONTROL = dict(hidden_size=64, intermediate_size=256, ans_num=64,
               visual_feat_dim=64, visual_embedding_dim=64)


def tiny_run(bench: Benchmark, workload: str, **config) -> Run:
    cell = bench.cell(workload)
    ov = overrides(bench, workload, **config)
    cfg = dict(bench.config(cell["config"]), **ov["config"])
    trf = dict(bench.traffic(cell["traffic"]), **ov["traffic"])
    return Run(bench, cell, cfg, trf, cells.family(cfg), SEED, 0.0, False,
               torch.device("cpu"), time.perf_counter(),
               bench.limits(workload))


@pytest.mark.parametrize("workload", TRAINING + ANSWERING)
def test_the_control_is_refused(workload, answer_bench):
    run = tiny_run(answer_bench, workload, **CONTROL)
    fp8 = Precision("fp8")
    if workload in TRAINING:
        from portbench.drivers.stage2_train import reference_outputs

        readings = training_readings(reference_outputs(run, fp8),
                                     reference_outputs(run))
    else:
        from portbench.drivers.answer import reference_logits

        js = set(range(run.trf["pool_batches"]))
        low, ref = reference_logits(run, js, fp8), reference_logits(run, js)
        rows = torch.arange(run.trf["batch_size"])
        readings = answer_readings([(j, rows, low[j]) for j in js], ref, 0)
    correct, rows = judge(readings, run.limits)
    assert not correct, rows


def _patch_step(monkeypatch, wrap):
    from crvqa_tpu_torch.train import stage2

    make = stage2.make_train_step
    monkeypatch.setattr(stage2, "make_train_step",
                        lambda *a, **k: wrap(make(*a, **k)))


def _patch_eval(monkeypatch, wrap):
    from crvqa_tpu_torch.train import stage2

    make = stage2.make_eval_step
    monkeypatch.setattr(stage2, "make_eval_step",
                        lambda *a, **k: wrap(make(*a, **k)))


def _half(batch):
    n = batch["input_ids"].shape[0]
    return {k: v[:n // 2] for k, v in batch.items()}


@pytest.mark.parametrize("workload", TRAINING)
def test_a_step_that_leaves_its_state_unchanged_is_refused(workload,
                                                            monkeypatch):
    from crvqa_tpu_torch.train.common import HfAdamW

    monkeypatch.setattr(HfAdamW, "step", lambda self, *a, **k: None)
    out, rows = run_tiny(workload)
    assert not out["correct"], rows


@pytest.mark.parametrize("workload", TRAINING)
def test_half_the_batch_left_out_is_refused(workload, monkeypatch):
    _patch_step(monkeypatch, lambda step: lambda s, b: step(s, _half(b)))
    out, rows = run_tiny(workload)
    assert not out["correct"], rows


@pytest.mark.parametrize("workload", ANSWERING)
def test_an_altered_answer_is_refused(workload, monkeypatch, answer_bench):
    gen = torch.Generator().manual_seed(0)

    def wrap(step):
        def altered(state, batch):
            logits = step(state, batch).clone()
            row = int(torch.randint(logits.shape[0], (), generator=gen))
            logits[row] = logits[row].flip(0)
            return logits
        return altered

    _patch_eval(monkeypatch, wrap)
    out, rows = run_tiny(workload, bench=answer_bench)
    assert not out["correct"], rows


@pytest.mark.parametrize("workload", ANSWERING)
def test_half_the_answers_left_out_is_refused(workload, monkeypatch,
                                              answer_bench):
    def wrap(step):
        def half(state, batch):
            logits = step(state, _half(batch))
            return torch.cat([logits, torch.zeros_like(logits)])
        return half

    _patch_eval(monkeypatch, wrap)
    out, rows = run_tiny(workload, bench=answer_bench)
    assert not out["correct"], rows
