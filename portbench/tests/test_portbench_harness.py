"""The harness is driven by data: every driver runs at the tiny presets
through `run_cell` and prints a line with the contract's keys; a cell
added as files alone (a configuration, a traffic mix, limits and an entry
in BENCHMARK.json) is listed and runs; the command refuses to run without
a card, and in a checkout without the program."""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness.cells import Benchmark
from portbench.harness.core import judge, run_cell
from portbench.tests.tiny import (ANSWER_CELL, CONFIGS, SEED, bench_with,
                                  run_tiny)

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = Benchmark()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", BENCH.workloads() + [ANSWER_CELL["name"]])
def test_each_driver_prints_the_contract_keys(workload, traced,
                                              answer_bench):
    out, rows = run_tiny(workload, traced=traced, bench=answer_bench)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in answer_bench.metrics(workload, kind)}
    assert set(out["metrics"]) <= names
    if not traced:
        # every end-to-end metric is read on any device
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert out["device"]["count"] == 1 and out["attempted"] > 0
    assert out["failed"] == 0 and out["correct"]
    assert [r[0] for r in rows] == list(answer_bench.limits(workload))
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
    json.dumps(out)


def test_a_cell_added_as_files_is_listed_and_runs(tmp_path):
    """A configuration, a traffic mix and limits as new files, and entries
    in BENCHMARK.json: nothing else changes."""
    (tmp_path / "portbench/configs").mkdir(parents=True)
    (tmp_path / "portbench/traffic").mkdir()
    (tmp_path / "portbench/limits").mkdir()
    cfg = json.loads((ROOT / "portbench/configs/lxmert-base.json").read_text())
    cfg.update(CONFIGS["lxmert-base"], l_layers=1, x_layers=1)
    (tmp_path / "portbench/configs/lxmert-small.json").write_text(
        json.dumps(cfg))
    trf = json.loads(
        (ROOT / "portbench/traffic/stage2-b2048.json").read_text())
    trf.update(batch_size=6, logging_steps=3,
               check={"steps": 3, "block_rows": 4})
    (tmp_path / "portbench/traffic/stage2-b6.json").write_text(
        json.dumps(trf))
    (tmp_path / "portbench/limits/lxmert-small-stage2-b6.json").write_text(
        (ROOT / "portbench/limits/lxmert-stage2-b2048.json").read_text())
    cell = {"name": "lxmert-small-stage2-b6", "config": "lxmert-small",
            "traffic": "stage2-b6", "chips": 1, "why": "x"}

    def edit(spec):
        spec["configs"].append({"name": "lxmert-small", "source": "x",
                                "file": "portbench/configs/lxmert-small.json",
                                "reduced": [], "why": "x"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "lxmert-stage2-b2048" in m.get("workloads", []):
                m["workloads"].append(cell["name"])

    bench = bench_with(tmp_path, [cell], {}, edit)
    assert cell["name"] in bench.workloads()
    run = lambda traced: run_cell(bench, cell["name"], SEED, 0.5, traced,
                                  "cpu", time.perf_counter())[0]
    out = run(False)
    assert out["correct"] and set(out["metrics"]) == {
        "train_ex_s", "peak_gib", "setup_s"}
    assert "reset_ms.train" in run(True)["metrics"]


def _run_command(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "lxmert-stage2-b2048", "--seed", "3141592653", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120)


def test_the_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run_command(ROOT)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_the_command_fails_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run_command(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_judge_needs_every_reading_finite_and_under_its_limit():
    limits = {"a": 1.0, "b": 0}
    assert judge({"a": 0.5, "b": 0.0}, limits)[0]
    assert not judge({"a": 1.5, "b": 0.0}, limits)[0]
    assert not judge({"a": float("nan"), "b": 0.0}, limits)[0]
    assert not judge({"a": 0.5}, limits)[0]
    # a reading with no limit is not compared
    ok, rows = judge({"a": 0.5, "b": 0.0, "c": 9.0}, limits)
    assert ok and [r[0] for r in rows] == ["a", "b"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """On a card: one short run of the VisualBERT cell through the command,
    correct and with its end-to-end metrics."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "visualbert-stage2-b2048", "--seed", "2718281829", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"train_ex_s", "peak_gib", "setup_s"}
