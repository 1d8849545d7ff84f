"""The port's trace and metrics sinks (crvqa_tpu_torch/utils/profiling.py,
utils/tb_events.py, `cli/common.py`'s `log_step` and `ProfileWindow`)
against the JAX package's (`crvqa_tpu.utils`, `crvqa_tpu.cli.common`):

- CRC32C and the event files: byte-identical for the same scalars, wall
  times and host name; the port's reader reads both;
- `metrics.jsonl`: the same lines (unrounded `float(v)`, non-numbers kept);
  `log_step`'s stdout line rounded to 6 places on both sides;
- `ProfileWindow`: the same start and stop steps as the JAX window
  (recorded through a monkeypatched `jax.profiler`), for strides of 1 and
  more, one-shot, and `close`; on the CPU the Chrome trace holds exactly
  the active steps' marked work, the warm-up step's not;
- the five training CLIs, tiny on the CPU, with `--profile_dir`,
  `--tensorboard_dir`: a trace, and event-file scalars equal to
  `metrics.jsonl`'s; `--wandb_project` without wandb prints the JAX
  package's notice and keeps the other sinks.
"""
import argparse
import glob
import json
import os
import socket
import struct
import sys
import time

import jax
import numpy as np
import pytest
import torch

from crvqa_tpu.cli import common as jcommon
from crvqa_tpu.utils import profiling as jprof
from crvqa_tpu.utils import tb_events as jtb
from crvqa_tpu_torch.cli import common as tcommon
from crvqa_tpu_torch.utils import profiling as tprof
from crvqa_tpu_torch.utils import tb_events as ttb

SCALARS = [("loss", 1.5, 10), ("loss", -0.1234567, 20),
           ("eval/acc", 42.25, 20), ("ex_s", 3e38, 2 ** 40),
           ("score", 0.0, -3)]


@pytest.mark.parametrize("data", [b"", b"123456789", b"\x00" * 32,
                                  b"\xff" * 32, bytes(range(256))])
def test_crc32c_matches_jax(data):
    assert ttb.crc32c(data) == jtb.crc32c(data)
    assert ttb._masked_crc(data) == jtb._masked_crc(data)


def _fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


def test_event_files_byte_identical_to_jax(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    files = {}
    for tag, mod in (("jax", jtb), ("port", ttb)):
        w = mod.TBEventWriter(str(tmp_path / tag))
        for name, value, step in SCALARS:
            w.add_scalar(name, value, step)
        w.add_scalar("late", 2.0, 5, wall_time=1700000123.5)
        w.close()
        (path,) = glob.glob(str(tmp_path / tag / "events.out.tfevents.*"))
        files[tag] = path
    assert os.path.basename(files["jax"]) == os.path.basename(files["port"])
    with open(files["jax"], "rb") as a, open(files["port"], "rb") as b:
        assert a.read() == b.read()
    f32 = lambda v: struct.unpack("<f", struct.pack("<f", v))[0]
    want = [(1700000000.25, s, n, f32(v)) for n, v, s in SCALARS]
    want.append((1700000123.5, 5, "late", 2.0))
    assert ttb.read_scalars(files["jax"]) == want
    assert len(ttb.read_records(files["port"])) == len(want) + 1


def test_reader_refuses_a_corrupt_record(tmp_path):
    w = ttb.TBEventWriter(str(tmp_path))
    w.add_scalar("loss", 1.0, 1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-5] ^= 1  # a payload byte of the last record
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_scalars(w.path)


METRICS = [dict(loss=1.25, score=np.float32(0.3), epoch=0, note="text"),
           dict(eval_acc=np.float64(41.123456789), flag=True),
           dict(preempted=True, checkpoint="/x/ckpt_4"),
           dict(count=np.int64(7), ratio=1 / 3)]


def test_metrics_writer_lines_match_jax(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    for tag, mod in (("jax", jprof), ("port", tprof)):
        w = mod.MetricsWriter(str(tmp_path / tag),
                              tensorboard_dir=str(tmp_path / tag / "tb"))
        for i, m in enumerate(METRICS):
            w.write(i + 1, **m)
        w.close()
    for name in ("metrics.jsonl", "tb"):
        if name == "tb":
            (a,) = glob.glob(str(tmp_path / "jax" / "tb" / "events.*"))
            (b,) = glob.glob(str(tmp_path / "port" / "tb" / "events.*"))
        else:
            a, b = (tmp_path / t / name for t in ("jax", "port"))
        assert open(a, "rb").read() == open(b, "rb").read(), name
    lines = [json.loads(x) for x in open(tmp_path / "port" /
                                         "metrics.jsonl")]
    assert lines[1]["eval_acc"] == 41.123456789  # unrounded
    assert lines[2]["checkpoint"] == "/x/ckpt_4"


def test_log_step_matches_jax(tmp_path, capsys):
    """stdout rounded to 6 places, metrics.jsonl unrounded, line for line
    as the JAX package's `log_step` writes them."""
    out = {}
    for tag, mod in (("jax", jcommon), ("port", tcommon)):
        args = argparse.Namespace(output_dir=str(tmp_path / tag),
                                  tensorboard_dir=None, wandb_project=None)
        mod.init_metrics(args)
        capsys.readouterr()
        # np.int64 is left out: neither stdout line takes it
        for i, m in enumerate(METRICS[:-1]):
            mod.log_step(i + 1, **m)
        mod.log_step(9, loss=0.1234567891, ex_s=round(1234.56, 1))
        out[tag] = capsys.readouterr().out
        mod._metrics_writer.close()
        mod._metrics_writer = None
    assert out["port"] == out["jax"]
    assert '"loss": 0.123457' in out["port"]
    a, b = (open(tmp_path / t / "metrics.jsonl").read()
            for t in ("jax", "port"))
    assert a == b
    assert '"loss": 0.1234567891' in b


def test_step_timer_summary_matches_jax(monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.125))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    out = []
    for mod in (jprof, tprof):
        t = mod.StepTimer(warmup=1)
        for _ in range(4):
            t.start()
            t.stop()
        out.append(t.summary(batch_size=8))
    assert out[0] == out[1]
    assert set(out[1]) == {"steps", "mean_step_ms", "min_step_ms",
                           "examples_per_sec"}


# ------------------------------------------------------------- windows

class _FakeProfile:
    """Stands in for torch.profiler.profile: records the ticks at which
    the window opens, turns active and stops."""

    log: list = []
    tick = None

    def __init__(self, activities=None, schedule=None):
        self.warmup = schedule is not None

    def start(self):
        self.log.append(("open", _FakeProfile.tick))
        if not self.warmup:
            self.log.append(("start", _FakeProfile.tick))

    def step(self):
        self.log.append(("start", _FakeProfile.tick))

    def stop(self):
        self.log.append(("stop", _FakeProfile.tick))


def _windows(tmp_path, monkeypatch, start, steps, stride, ticks,
             close_at=None):
    """(JAX events, port events): (what, tick step) of each window."""
    jlog = []
    _FakeProfile.log = plog = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: jlog.append(("start", cur[0])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: jlog.append(("stop", cur[0])))
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(tprof, "export_trace", lambda prof, d: "trace")
    args = argparse.Namespace(profile_dir=str(tmp_path), device="cpu",
                              profile_start_step=start, profile_steps=steps)
    cur = [None]
    jw, tw = jcommon.ProfileWindow(args), tcommon.ProfileWindow(args)
    for step in range(stride, stride * ticks + 1, stride):
        cur[0] = _FakeProfile.tick = step
        jw.tick(step)
        tw.tick(step)
        if step == close_at:
            jw.close()
            tw.close()
    jw.close()
    tw.close()
    return jlog, plog


@pytest.mark.parametrize("start,steps,stride", [
    (3, 2, 1), (10, 5, 1), (0, 3, 1), (1, 2, 1), (4, 5, 3), (5, 2, 4),
    (6, 1, 2)])
def test_profile_window_steps_match_jax(tmp_path, monkeypatch, start, steps,
                                        stride):
    jlog, plog = _windows(tmp_path, monkeypatch, start, steps, stride, 20)
    active = [e for e in plog if e[0] != "open"]
    assert active == jlog and len(jlog) == 2
    opened = [t for what, t in plog if what == "open"]
    first = stride  # the first tick
    # the session opens one tick before the JAX start, where there is one
    assert opened == [jlog[0][1] - stride if jlog[0][1] > first
                      else jlog[0][1]]


def test_profile_window_is_one_shot_and_close_ends_it(tmp_path,
                                                      monkeypatch):
    # stopped at step 6 and never re-armed
    jlog, plog = _windows(tmp_path, monkeypatch, 3, 3, 1, 30)
    assert [e for e in plog if e[0] != "open"] == jlog == [
        ("start", 3), ("stop", 6)]
    # a run that ends inside the window: close() at its last tick stops it
    jlog, plog = _windows(tmp_path, monkeypatch, 3, 50, 1, 8)
    assert [e for e in plog if e[0] != "open"] == jlog == [
        ("start", 3), ("stop", 8)]
    # closed explicitly (a preemption) mid-window: the same tick on both
    jlog, plog = _windows(tmp_path, monkeypatch, 2, 10, 1, 20, close_at=5)
    assert [e for e in plog if e[0] != "open"] == jlog == [
        ("start", 2), ("stop", 5)]


def test_profile_window_traces_exactly_the_active_steps(tmp_path):
    """The real torch.profiler on the CPU: start 3, 2 steps; the session
    opens at tick 2, step 3 is its warm-up, steps 4 and 5 are active (the
    JAX package's trace), and no other step's marker is in the trace."""
    args = argparse.Namespace(profile_dir=str(tmp_path), device="cpu",
                              profile_start_step=3, profile_steps=2)
    w = tcommon.ProfileWindow(args)
    x = torch.ones(8)
    for step in range(1, 9):
        with torch.profiler.record_function(f"marker_step_{step}"):
            x = x * 1.0001
        w.tick(step)
    w.close()
    events = json.load(open(w.path))["traceEvents"]
    seen = sorted({e["name"] for e in events
                   if e.get("name", "").startswith("marker_step_")})
    assert seen == ["marker_step_4", "marker_step_5"]
    assert os.path.dirname(w.path) == str(tmp_path)


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        with torch.profiler.record_function("inside"):
            torch.ones(4).sum()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert any(e.get("name") == "inside"
               for e in json.load(open(path))["traceEvents"])
    with tprof.trace(None):  # no-op
        pass


# ---------------------------------------------------------------- CLIs

TINY = ["--tiny", "--device", "cpu", "--dtype", "float32", "--seed", "0"]


def _cli_argv(name, tmp_path):
    from crvqa_tpu_torch.cli import (prune_debias_vqa,
                                     prune_debias_vqa_visualbert,
                                     run_vqa_stage1, run_vqa_stage3,
                                     vqa_mplug)

    lxmert = [*TINY, "--synthetic", "32", "--train_batch_size", "8",
              "--eval_batch_size", "8", "--num_train_epochs", "1",
              "--logging_steps", "1", "--do_train"]
    table = {
        "stage2": (prune_debias_vqa, lxmert + ["--save_steps", "2",
                                               "--evaluate_during_training"]),
        "stage2_visualbert": (prune_debias_vqa_visualbert,
                              lxmert + ["--save_steps", "2",
                                        "--evaluate_during_training"]),
        "stage1": (run_vqa_stage1, lxmert + ["--do_eval"]),
        "stage3": (run_vqa_stage3, lxmert + ["--do_eval", "--training_type",
                                             "FT_randMask"]),
        "mplug": (vqa_mplug, [*TINY, "--synthetic", "16",
                              "--train_batch_size", "4",
                              "--eval_batch_size", "4",
                              "--num_train_epochs", "1",
                              "--masker_update_step", "2",
                              "--logging_steps", "1", "--save_steps", "100",
                              "--beam_size", "2", "--max_answer_len", "4",
                              "--do_train", "--do_eval"]),
    }
    cli, argv = table[name]
    return cli, argv + [
        "--output_dir", str(tmp_path / "out"),
        "--profile_dir", str(tmp_path / "prof"), "--profile_start_step", "1",
        "--profile_steps", "2", "--tensorboard_dir", str(tmp_path / "tb")]


def _f32(v):
    return struct.unpack("<f", struct.pack("<f", v))[0]


@pytest.mark.parametrize("name", ["stage2", "stage2_visualbert", "stage1",
                                  "stage3", "mplug"])
def test_training_cli_writes_trace_and_event_file(tmp_path, name):
    cli, argv = _cli_argv(name, tmp_path)
    summary = cli.main(argv)
    assert summary["step"] == 4
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert summary["trace"] == trace
    assert json.load(open(trace))["traceEvents"]
    lines = [json.loads(x) for x in open(tmp_path / "out" / "metrics.jsonl")]
    want = [(line["step"], k, _f32(v)) for line in lines
            for k, v in line.items() if k != "step" and isinstance(v, float)]
    (events,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    got = [(s, tag, v) for _, s, tag, v in ttb.read_scalars(events)]
    assert got == want
    assert any(t == "loss" for _, t, _ in got)
    tcommon._metrics_writer.close()


def test_wandb_absent_prints_the_notice_and_keeps_the_sinks(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb fails
    notices = []
    for tag, mod in (("jax", jprof), ("port", tprof)):
        capsys.readouterr()
        w = mod.MetricsWriter(str(tmp_path / tag), wandb_project="w",
                              tensorboard_dir=str(tmp_path / tag / "tb"))
        w.write(1, loss=2.0)
        w.close()
        notices.append(capsys.readouterr().out)
    assert notices[0] == notices[1]
    assert notices[1].startswith("# wandb disabled (")
    from crvqa_tpu_torch.cli import prune_debias_vqa

    out = tmp_path / "cli"
    prune_debias_vqa.main([*TINY, "--synthetic", "16",
                           "--train_batch_size", "8", "--num_train_epochs",
                           "1", "--logging_steps", "1", "--do_train",
                           "--output_dir", str(out), "--wandb_project", "w",
                           "--tensorboard_dir", str(tmp_path / "cli_tb")])
    assert notices[1] in capsys.readouterr().out
    lines = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [x["step"] for x in lines if "loss" in x] == [1, 2]
    (events,) = glob.glob(str(tmp_path / "cli_tb" / "events.*"))
    assert len(ttb.read_scalars(events)) == sum(
        isinstance(v, float) for x in lines for k, v in x.items()
        if k != "step")
    tcommon._metrics_writer.close()


def test_serve_mplug_accepts_and_ignores_the_sink_flags():
    """As the JAX server does: serve_mplug parses the three flags as the
    JAX server parses them (it refuses no flag of vqa_mplug's argv: the
    runtime's it logs as not read, tests/test_torch_serve_mplug.py)."""
    from crvqa_tpu.cli import serve_mplug as jserve
    from crvqa_tpu_torch.cli import serve_mplug

    argv = ["--output_dir", "o", "--profile_dir", "p", "--tensorboard_dir",
            "t", "--wandb_project", "w"]
    args = serve_mplug.build_parser().parse_args(argv)
    jargs = jserve.build_parser().parse_args(argv)
    for name in ("profile_dir", "tensorboard_dir", "wandb_project"):
        assert getattr(args, name) == getattr(jargs, name)
        assert name not in tcommon.MESH_FLAGS
