"""The `mplug-mask-b128` cell on the CPU: a tiny run through the whole
harness (`tiny_mplug.CONFIG`) holds the program to the plain reference
to rounding, untraced and traced; the output check refuses the control
(the reference in float8 in the program's place) and half of every batch
left out of the step, by the cell's own limits; the benchmark's FLOP
count equals a hand count at the published widths; the mid-length
attention bound counts the decoder's cross-attention at its grouped
shape; a run loads no JAX module."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from portbench.counts.attention import bound_s, call_cost
from portbench.counts.mplug import count_step
from portbench.harness import cells
from portbench.harness.cells import Benchmark
from portbench.harness.check import training_readings
from portbench.harness.core import Run, judge
from portbench.reference.common import Precision
from portbench.tests import tiny_mplug  # noqa: F401 (registers the preset)
from portbench.tests.tiny import SEED, overrides, run_tiny

CELL = "mplug-mask-b128"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers run beside each other, and
    the shared harness tests time short windows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

BENCH = Benchmark()
PEAKS = {"bfloat16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
# the control's size: twice the tiny width
CONTROL = dict(vision_width=64, hidden_size=64, intermediate_size=256)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_a_tiny_run_matches_the_reference(traced):
    out, rows = run_tiny(CELL, traced=traced)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert [r[0] for r in rows] == list(BENCH.limits(CELL))
    for name, value, _ in rows:
        assert value <= 1e-5, (name, value)
    if not traced:
        assert set(out["metrics"]) == {"train_ex_s", "peak_gib", "setup_s"}


def tiny_run(**config) -> Run:
    cell = BENCH.cell(CELL)
    ov = overrides(BENCH, CELL, **config)
    cfg = dict(BENCH.config(cell["config"]), **ov["config"])
    trf = dict(BENCH.traffic(cell["traffic"]), **ov["traffic"])
    return Run(BENCH, cell, cfg, trf, cells.family(cfg), SEED, 0.0, False,
               torch.device("cpu"), time.perf_counter(), BENCH.limits(CELL))


def test_the_control_is_refused():
    from portbench.drivers.mplug_mask_train import reference_outputs

    run = tiny_run(**CONTROL)
    readings = training_readings(reference_outputs(run, Precision("fp8")),
                                 reference_outputs(run))
    correct, rows = judge(readings, run.limits)
    assert not correct, rows


def test_half_the_batch_left_out_is_refused(monkeypatch):
    from crvqa_tpu_torch.train import mplug_train

    make = mplug_train.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)
        return lambda state, batch: step(state, {
            key: v[:v.shape[0] // 2] for key, v in batch.items()})

    monkeypatch.setattr(mplug_train, "make_train_step", halved)
    out, rows = run_tiny(CELL)
    assert not out["correct"], rows


def hand_count(cfg: dict, trf: dict, b: int) -> int:
    """Forward and backward product FLOPs of one mask-training step: a
    product y = x W costs 2 m k n forward, as much again for dx when x
    depends on a trained leaf and for dW when W is trained (a masked
    weight or an LM-head leaf); an attention 4 b H Sq Sk D forward and 8
    backward when its inputs depend on a trained leaf."""
    w, h, inter = cfg["vision_width"], cfg["hidden_size"], cfg[
        "intermediate_size"]
    s = (cfg["image_res"] // cfg["patch_size"]) ** 2 + 1
    lq = trf["question_tokens"]["max"]
    a, length = trf["answers"]["slots"], trf["answers"]["tokens"]
    total = 0

    def mm(rows, k, n, dx, dw):
        nonlocal total
        total += 2 * rows * k * n * (1 + dx + dw)

    def att(sq, sk, width, grad):
        nonlocal total
        total += (4 + 8 * grad) * b * sq * sk * width

    mm(b * (s - 1), 3 * cfg["patch_size"] ** 2, w, 0, 0)
    t = b * s
    for i in range(cfg["vision_layers"]):
        live = i > 0  # block 0's attention input depends on nothing trained
        mm(t, w, 3 * w, live, 0)
        att(s, s, w, live)
        mm(t, w, w, live, 0)
        mm(t, w, 4 * w, live, 1)
        mm(t, 4 * w, w, 1, 1)

    def bert_ffn(rows):
        mm(rows, h, inter, 1, 1)
        mm(rows, inter, h, 1, 1)

    def self_att(rows, seq, batch_rows, first):
        for _ in range(3):
            mm(rows, h, h, not first, 1)
        nonlocal total
        total += 12 * batch_rows * seq * seq * h
        mm(rows, h, h, 1, 1)

    tq = b * lq
    for i in range(cfg["text_encoder_layers"]):
        self_att(tq, lq, b, i == 0)
        bert_ffn(tq)
    for rel in range(cfg["fusion_layers"]):
        if rel and rel % cfg["stride_layer"] == 0:
            self_att(b * (s + lq), s + lq, b, False)
            bert_ffn(b * (s + lq))
            continue
        self_att(tq, lq, b, False)
        mm(tq, h, h, 1, 1)                  # cross query
        for _ in range(2):
            mm(b * s, h, h, 1, 1)           # cross key, value over the image
        att(lq, s, h, 1)
        mm(tq, h, h, 1, 1)                  # cross output
        bert_ffn(tq)
    ta, mem = b * a * length, s + lq
    for i in range(cfg["text_decode_layers"]):
        self_att(ta, length, b * a, i == 0)
        mm(ta, h, h, 1, 1)                  # cross query
        for _ in range(2):
            mm(b * mem, h, h, 1, 1)         # key, value: each memory once
        att(a * length, mem, h, 1)          # grouped: A*L queries a question
        mm(ta, h, h, 1, 1)
        bert_ffn(ta)
    mm(ta, h, h, 1, 1)                      # the LM head's transform
    mm(ta, h, cfg["vocab_size"], 1, 0)      # tied word embeddings, frozen
    return total


def test_the_count_is_the_hand_count_at_published_widths():
    cfg, trf = BENCH.config("mplug-base"), BENCH.traffic(CELL)
    flops, calls = count_step(cfg, trf, batch=2)
    assert flops == hand_count(cfg, trf, 2)
    assert count_step(cfg, trf)[0] == 64 * flops  # linear in the batch
    # 12 ViT, 6 text, 5 + 1 fusion, 12 + 12 decoder attention calls
    assert len(calls) == 12 + 6 + 5 * 2 + 1 + 24
    assert sum(not c[5] for c in calls) == 1  # the ViT's first block


def test_the_mid_length_bound_counts_the_grouped_cross_attention():
    cfg, trf = BENCH.config("mplug-base"), BENCH.traffic(CELL)
    _, calls = count_step(cfg, trf)
    b, heads, d = trf["batch_size"], cfg["num_attention_heads"], 64
    mem = 577 + trf["question_tokens"]["max"]
    grouped = (b, heads, 10 * 12, mem, d, True)
    assert sum(c == grouped for c in calls) == cfg["text_decode_layers"]
    mid = [c for c in calls if c[1] * max(c[2], c[3]) > 1024]
    # the ViT (577), the fusion cross (25 x 577), the stride layer (602)
    # and the decoder's grouped cross-attention; not the short ones
    assert sorted({(c[2], c[3]) for c in mid}) == [
        (25, 577), (120, mem), (577, 577), (mem, mem)]
    # replicated, each answer row would read its question's memory again
    replicated = (b * 10, heads, 12, mem, d, True)
    _, one = call_cost(grouped, "forward", 2)
    _, many = call_cost(replicated, "forward", 2)
    assert many > 8 * one
    assert bound_s([grouped], ("forward",), 2, PEAKS) < bound_s(
        [replicated], ("forward",), 2, PEAKS)


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.tests.tiny_mplug;"
            "from portbench.tests.tiny import run_tiny;"
            "from portbench.harness.main import forbidden_modules;"
            "out, _ = run_tiny('mplug-mask-b128', seconds=0.1);"
            "assert out['correct'];"
            "print(forbidden_modules())")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=str(BENCH.root), capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
