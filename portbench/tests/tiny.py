"""Tiny presets of the cells for the CPU tests: the same configurations
and traffic mixes at a few units of width and depth, in float32 (the
program's plain versions then agree with the reference to rounding)."""
from __future__ import annotations

import time

import torch

from portbench.harness.cells import Benchmark
from portbench.harness.core import run_cell

CONFIGS = {
    "lxmert-base": dict(vocab_size=128, hidden_size=32,
                        num_attention_heads=4, l_layers=2, r_layers=1,
                        x_layers=2, intermediate_size=64,
                        max_position_embeddings=32, visual_feat_dim=16,
                        ans_num=16, dtype="float32"),
    "visualbert-base": dict(vocab_size=128, hidden_size=32,
                            num_attention_heads=4, num_hidden_layers=2,
                            intermediate_size=64, max_position_embeddings=32,
                            visual_embedding_dim=16, ans_num=16,
                            dtype="float32"),
}
TRAFFIC = {"batch_size": 8, "check": {"steps": 3, "block_rows": 3},
           "profile": {"start": 1, "steps": 2}, "sample_rows": 8,
           "logging_steps": 4}
SEED = 3141592653  # above 2**31: a seed may exceed 32 signed bits


def overrides(bench: Benchmark, workload: str, **config) -> dict:
    cell = bench.cell(workload)
    return {"config": dict(CONFIGS[cell["config"]], **config),
            "traffic": dict(TRAFFIC)}


def run_tiny(workload: str, traced: bool = False, seconds: float = 0.5,
             bench: Benchmark = None, seed: int = SEED, **config):
    """(result, checked rows) of one tiny run on the CPU."""
    torch.manual_seed(0)
    bench = bench or Benchmark()
    return run_cell(bench, workload, seed, seconds, traced, "cpu",
                    time.perf_counter(), overrides(bench, workload, **config))


# The answering cell is ready as files (traffic/answer-b2048.json,
# drivers/answer.py, limits/lxmert-answer-b2048.json, the `.answer`
# readers) and not yet in BENCHMARK.json (PERF.md §7): its entry and its
# metrics, as a later benchmark change adds them.
ANSWER_CELL = {"name": "lxmert-answer-b2048", "config": "lxmert-base",
               "traffic": "answer-b2048", "chips": 1, "why": "answering"}
ANSWER_METRICS = {
    "end_to_end": [{"name": "answer_q_s", "unit": "questions/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["lxmert-answer-b2048"]}],
    "per_layer": [{"name": f"{m}.answer", "unit": "%", "better": b,
                   "source": "device_trace", "layer": "x",
                   "moves": "answer_q_s",
                   "workloads": ["lxmert-answer-b2048"]}
                  for m, b in (("mfu", "higher"), ("attn_roofline", "higher"),
                               ("idle_share", "lower"))]}


def bench_with(root, cells: list, metrics: dict, edit=None) -> Benchmark:
    """A checkout at `root` holding this one's benchmark files (beside any
    already there) and BENCHMARK.json with `cells` and `metrics`
    ({'end_to_end': [...], 'per_layer': [...]}) added, then `edit(spec)`:
    a cell added as files and entries alone."""
    import json
    import pathlib
    import shutil

    src = pathlib.Path(Benchmark().root)
    root = pathlib.Path(root)
    for sub in ("configs", "traffic", "limits", "metrics", "counts"):
        shutil.copytree(src / "portbench" / sub, root / "portbench" / sub,
                        dirs_exist_ok=True)
    spec = json.loads((src / "BENCHMARK.json").read_text())
    spec["workloads"] += cells
    for kind, entries in metrics.items():
        spec[kind] += entries
    if edit is not None:
        edit(spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Benchmark(str(root))
