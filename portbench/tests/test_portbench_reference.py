"""The benchmark's plain references against the program (`crvqa_tpu_torch`)
on the CPU: the same parameter names and shapes at the published widths,
the same masked matrices, and at tiny widths in float32 the same training
steps (losses, first gradients, changes, reset thresholds) and answers,
through the whole harness, dropout included."""
from __future__ import annotations

import pytest
import torch

from portbench.families import lxmert, visualbert
from portbench.harness.cells import Benchmark
from portbench.tests.tiny import run_tiny

BENCH = Benchmark()
FAMILIES = {"lxmert-base": lxmert, "visualbert-base": visualbert}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_parameter_table_is_the_programs_state_dict(name):
    cfg = BENCH.config(name)
    fam = FAMILIES[name]
    model = fam.meta_model(cfg, torch.bfloat16)
    program = {k: tuple(v.shape) for k, v in model.named_parameters()}
    table = {n: tuple(s) for n, s, _ in fam.reference.param_table(cfg)}
    assert table == program


@pytest.mark.parametrize("name,count", [("lxmert-base", 168),
                                        ("visualbert-base", 74)])
def test_masked_matrices_are_the_programs(name, count):
    from crvqa_tpu_torch.masking.masker import weight_name

    cfg = BENCH.config(name)
    fam = FAMILIES[name]
    ref = fam.reference.masked_weights(cfg)
    program = [weight_name(s) for s in fam.masker(cfg).specs]
    assert sorted(n for n, _ in ref) == sorted(program)
    assert len(program) == count
    rates = fam.masker(cfg).zerorate_dict
    from portbench.reference.stage2 import zero_rates

    assert zero_rates(cfg) == rates


@pytest.mark.parametrize("workload", ["lxmert-stage2-b2048",
                                      "visualbert-stage2-b2048",
                                      "lxmert-answer-b2048"])
def test_reference_matches_the_program_at_tiny_width(workload, answer_bench):
    out, rows = run_tiny(workload, bench=answer_bench)
    assert out["correct"], rows
    for name, value, _ in rows:
        assert value <= 1e-5, (name, value)
