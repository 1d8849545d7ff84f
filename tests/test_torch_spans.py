"""The port's spans (`crvqa_tpu_torch/utils/profiling.py`: `span`,
`tracing`, `spans`, `clear`) inside the stage-2 step, the threshold reset,
`predict` and the prefetch consumer, and `--profile_dir`'s use of them.

- Recording on, the tiny LXMERT and VisualBERT stage-2 steps give the
  same losses, scores, moments and thresholds, bit for bit, as off.
- A step records `train_step` holding one `mask_apply`, `forward` and
  `backward` per microbatch and one `optimizer`, all under the step's
  identifier; `grad_sync` only with a mesh.
- Off, `span` is the shared null context and records nothing.
- The reset, `predict`'s `eval_step` / `fetch` and the prefetch
  consumer's `data_wait` are roots; `predict`'s carry the batch's index.
- An mPLUG mask step records the same tree, its `forward` holding the
  model's `visual_encoder`, `text_fusion` and `decoder`, siblings in
  order and apart inside their parent; the reset is a root; recording changes no output and,
  off, nothing is recorded.
- A stage-2 CLI run with `--profile_dir` writes a Chrome trace holding
  the `crvqa.*` annotations; on a CUDA device the window logs each span's
  device ms per step.
"""
import argparse
import glob
import json

import numpy as np
import pytest
import torch

from crvqa_tpu_torch.cli import common
from crvqa_tpu_torch.data.prefetch import prefetch_batches
from crvqa_tpu_torch.data.synthetic import synthetic_batch
from crvqa_tpu_torch.masking.masker import Masker
from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
from crvqa_tpu_torch.models import LxmertConfig, VisualBertConfig
from crvqa_tpu_torch.train import mplug_train, stage2
from crvqa_tpu_torch.train.evaluation import predict
from crvqa_tpu_torch.utils import profiling
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

STEP_CHILDREN = ["mask_apply", "forward", "backward", "optimizer"]


@pytest.fixture(autouse=True)
def recording_off():
    """Every test starts and ends with recording off and no records."""
    profiling.tracing(False)
    profiling.clear()
    yield
    profiling.tracing(False)
    profiling.clear()


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()
           if k not in ("valid", "question_id")}
    out["input_ids"] = out["input_ids"].long()
    out["max_label"] = out["max_label"].long()
    return out


def _program(model_name, accum=1, mesh=None):
    """(train step, reset, eval step, fresh state, 3 batches) of the tiny
    stage-2 program in float32, dropout on."""
    if model_name == "lxmert":
        cfg = LxmertConfig.tiny(dtype=torch.float32)
        params = common.lxmert_initial_params(cfg, 0, None)
        masker = Masker.create(
            lxmert_mask_specs(cfg.l_layers, cfg.r_layers, cfg.x_layers),
            ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7),
            controlled_init="magnitude")
        model, key, style = stage2.lxmert_meta_model(cfg), "classifier", {
            "feat_dim": cfg.visual_feat_dim, "style": "lxmert"}
    else:
        cfg = VisualBertConfig.tiny(dtype=torch.float32)
        params = common.visualbert_initial_params(cfg, 0, None)
        masker = common.visualbert_uniform_masker(cfg, 0.7)
        model, key, style = stage2.visualbert_meta_model(cfg), "cls", {
            "feat_dim": cfg.visual_embedding_dim, "style": "visualbert"}
    sc = stage2.Stage2Config(masker_type="lmh", learning_rate=1e-3,
                             total_steps=20, hidden_size=cfg.hidden_size,
                             classifier_key=key, grad_accum_steps=accum)
    state, tx = stage2.init_state(model, masker, params, sc, seed=0,
                                  device="cpu")
    batches = [_torch_batch(synthetic_batch(
        batch_size=4, seq_len=8, num_boxes=5, ans_num=cfg.ans_num,
        vocab_size=cfg.vocab_size, seed=i, **style)) for i in range(3)]
    return (stage2.make_train_step(model, masker, tx, sc, mesh),
            stage2.make_threshold_reset(masker),
            stage2.make_eval_step(model, masker, sc), state, batches)


def _train(model_name, accum=1):
    """Two steps and a reset on a fresh state: (losses, state)."""
    step_fn, reset_fn, _, state, batches = _program(model_name, accum)
    losses = []
    for b in batches[:2]:
        state, m = step_fn(state, b)
        losses.append(m.loss)
    return losses, reset_fn(state)


@pytest.mark.parametrize("model_name", ["lxmert", "visualbert"])
def test_recording_changes_no_output_of_the_step(model_name):
    off_losses, off = _train(model_name)
    profiling.tracing(True)
    on_losses, on = _train(model_name)
    assert profiling.spans()
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    for part in ("scores", "thresholds"):
        a, b = getattr(off, part), getattr(on, part)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    for moment in ("mu", "nu"):
        a, b = getattr(off.opt_state, moment), getattr(on.opt_state, moment)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(off.train_params["classifier"][k], v)
               for k, v in on.train_params["classifier"].items())


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("model_name", ["lxmert", "visualbert"])
def test_a_step_records_its_layers_under_one_identifier(model_name, accum):
    step_fn, _, _, state, batches = _program(model_name, accum)
    step_fn(state, batches[0])  # step 0, unrecorded
    profiling.tracing(True)
    step_fn(state, batches[1])  # step 1
    recs = profiling.spans()
    assert recs[0].name == "train_step" and recs[0].parent is None
    assert [r.name for r in recs[1:]] == (
        ["mask_apply", "forward", "backward"] * accum + ["optimizer"])
    assert all(r.parent == 0 for r in recs[1:])
    assert {r.step for r in recs} == {1}
    assert all(r.host_start_ns <= r.host_end_ns for r in recs)
    assert recs[0].host_start_ns <= recs[1].host_start_ns
    assert recs[-1].host_end_ns <= recs[0].host_end_ns
    # off the card no device time; no mesh, no grad_sync
    assert all(r.device_ms is None for r in recs)
    assert "grad_sync" not in {r.name for r in recs}


def test_a_step_under_a_mesh_records_grad_sync():
    """A mesh of one rank without a process group: the step's layers with
    `grad_sync` between the backward and the optimizer."""
    from crvqa_tpu_torch.parallel.mesh import make_mesh

    step_fn, _, _, state, batches = _program("lxmert", mesh=make_mesh())
    profiling.tracing(True)
    step_fn(state, batches[0])
    recs = profiling.spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("train_step", None), ("mask_apply", 0), ("forward", 0),
        ("backward", 0), ("grad_sync", 0), ("optimizer", 0)]
    assert {r.step for r in recs} == {0}


def test_off_span_is_the_shared_null_context_and_records_nothing():
    a, b = profiling.span("train_step", 3), profiling.span("forward")
    assert a is b is profiling._NULL
    with a:
        with b:
            pass
    step_fn, reset_fn, _, state, batches = _program("lxmert")
    step_fn(state, batches[0])
    reset_fn(state)
    assert profiling.spans() == []
    profiling.tracing(True)
    assert profiling.span("forward") is not profiling._NULL
    profiling.tracing(False)
    assert profiling.span("forward") is profiling._NULL


def test_reset_is_a_root_span_under_the_state_step():
    step_fn, reset_fn, _, state, batches = _program("lxmert")
    step_fn(state, batches[0])
    profiling.tracing(True)
    reset_fn(state)
    (rec,) = profiling.spans()
    assert (rec.name, rec.step, rec.parent) == ("reset", 1, None)


def test_predict_records_eval_step_and_fetch_by_batch_index():
    _, _, eval_fn, state, batches = _program("lxmert")
    profiling.tracing(True)
    out = predict(eval_fn, state, iter(batches))
    assert out["logits"].shape[0] == 12
    recs = profiling.spans()
    want = []
    for i in range(3):
        want += [("eval_step", i, None), ("mask_apply", i, len(want)),
                 ("fetch", i, None)]
    assert [(r.name, r.step, r.parent) for r in recs] == want


def test_the_prefetch_consumer_records_data_wait():
    src = [{"x": np.full((2, 3), i, np.float32)} for i in range(4)]
    profiling.tracing(True)
    got = [b["x"] for b in prefetch_batches(iter(src), torch.device("cpu"))]
    assert [float(x[0, 0]) for x in got] == [0.0, 1.0, 2.0, 3.0]
    recs = profiling.spans()
    # one wait per batch and one for the end of the stream
    assert [r.name for r in recs] == ["data_wait"] * 5
    assert all(r.parent is None and r.step is None for r in recs)


def test_device_ms_per_step_sums_each_name_over_the_steps():
    R = profiling.SpanRecord
    recs = [R("train_step", 4, None, 0, 1, 10.0),
            R("forward", 4, 0, 0, 1, 3.0), R("forward", 4, 0, 0, 1, 1.0),
            R("train_step", 5, None, 0, 1, 12.0),
            R("forward", 5, 3, 0, 1, 2.0),
            R("fetch", 0, None, 0, 1, None)]  # untimed: left out
    assert profiling.device_ms_per_step(recs, 2) == {
        "train_step_ms": 11.0, "forward_ms": 3.0}
    assert profiling.device_ms_per_step(recs, 0) == {}


def _window_args(tmp_path):
    return argparse.Namespace(profile_dir=str(tmp_path), device="cpu",
                              profile_start_step=3, profile_steps=2)


def test_profile_window_records_spans_over_its_active_steps(tmp_path):
    """Start 3, 2 steps on the CPU: the spans of steps 4 and 5 are in the
    trace as `crvqa.*` annotations; recording is off after the window."""
    w = common.ProfileWindow(_window_args(tmp_path))
    on = []
    for step in range(1, 9):
        on.append(profiling._ON)
        with profiling.span("train_step", step):
            with profiling.span("forward"):
                torch.ones(8).sum()
        w.tick(step)
    w.close()
    assert on == [False] * 3 + [True] * 2 + [False] * 3
    events = json.load(open(w.path))["traceEvents"]
    marks = [e["name"] for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("crvqa.")]
    assert sorted(marks) == ["crvqa.forward"] * 2 + ["crvqa.train_step"] * 2
    assert profiling.spans() == [] and not profiling._ON


def test_profile_window_logs_span_device_ms_on_a_cuda_device(
        tmp_path, monkeypatch, capsys):
    """A window on a CUDA device (a CPU session relabelled before it
    stops, each record given 2 ms of device time) logs one line of each
    span's device ms per step."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    spans = profiling.spans

    def timed():
        recs = spans()
        for r in recs:
            r.device_ms = 2.0
        return recs

    monkeypatch.setattr(profiling, "spans", timed)
    w = common.ProfileWindow(_window_args(tmp_path))
    for step in range(1, 6):
        with profiling.span("train_step", step):
            for _ in range(3):
                with profiling.span("forward"):
                    torch.ones(4).sum()
        if step == 5:
            w.device = torch.device("cuda")
        capsys.readouterr()
        w.tick(step)  # the tick at step 5 closes the window
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    # steps 4 and 5: 2 train_steps and 6 forwards of 2 ms each
    assert lines == [{"step": 5, "train_step_ms": 2.0, "forward_ms": 6.0}]
    assert not profiling._ON


@pytest.mark.parametrize("cli", ["prune_debias_vqa",
                                 "prune_debias_vqa_visualbert"])
def test_stage2_cli_trace_holds_the_program_annotations(tmp_path, cli):
    import importlib

    main = importlib.import_module(f"crvqa_tpu_torch.cli.{cli}").main
    summary = main([
        "--tiny", "--device", "cpu", "--dtype", "float32", "--seed", "0",
        "--synthetic", "32", "--train_batch_size", "8",
        "--eval_batch_size", "8", "--num_train_epochs", "1",
        "--logging_steps", "2", "--save_steps", "2",
        "--evaluate_during_training", "--do_train",
        "--output_dir", str(tmp_path / "out"),
        "--profile_dir", str(tmp_path / "prof"), "--profile_start_step", "1",
        "--profile_steps", "2"])
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert summary["trace"] == trace
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    # steps 2 and 3, and the reset and the eval after step 2
    assert {f"crvqa.{n}" for n in ["train_step", *STEP_CHILDREN, "reset",
                                   "eval_step", "fetch"]} <= names
    assert not profiling._ON and profiling.spans() == []
    if common._metrics_writer is not None:
        common._metrics_writer.close()


MPLUG_TREE = [("train_step", None), ("mask_apply", 0), ("forward", 0),
              ("visual_encoder", 2), ("text_fusion", 2), ("decoder", 2),
              ("backward", 0), ("optimizer", 0)]


def _mplug_program(mesh=None):
    """(train step, reset, fresh state, 2 batches) of the tiny mPLUG mask
    training as `vqa_mplug` builds it, in float32, dropout on."""
    from crvqa_tpu_torch.cli import vqa_mplug
    from crvqa_tpu_torch.data.mplug_data import synthetic_mplug_batch

    args = vqa_mplug.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--dtype", "float32",
         "--output_dir", "unused"])
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    cfg = vqa_mplug.train_config(args, 10)
    state = mplug_train.init_state(
        model, vqa_mplug.initial_params(args, config), cfg, "cpu",
        masker=masker, seed=0, train=True)
    batches = [{k: torch.from_numpy(v) for k, v in synthetic_mplug_batch(
        batch_size=2, image_res=config.vit.image_res,
        vocab_size=config.bert.vocab_size, uint8_images=True,
        seed=i).items() if k != "qid"} for i in range(2)]
    return (mplug_train.make_train_step(model, cfg, masker, mesh=mesh),
            mplug_train.make_threshold_reset(masker), state, batches)


def _mplug_train():
    """Two steps and a reset on a fresh state: (losses, state)."""
    step_fn, reset_fn, state, batches = _mplug_program()
    losses = [step_fn(state, b)[1] for b in batches]
    return losses, reset_fn(state, 0.5)


def test_mplug_recording_changes_no_output_and_off_records_nothing():
    off_losses, off = _mplug_train()
    assert profiling.spans() == []
    profiling.tracing(True)
    on_losses, on = _mplug_train()
    assert profiling.spans()
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    for part in ("scores", "thresholds"):
        a, b = getattr(off, part), getattr(on, part)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    for moment in ("mu", "nu"):
        a, b = getattr(off.opt_state, moment), getattr(on.opt_state, moment)
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("with_mesh", [False, True], ids=["plain", "mesh"])
def test_an_mplug_step_records_its_tree_and_the_children_tile_it(
        with_mesh):
    from crvqa_tpu_torch.parallel.mesh import make_mesh

    step_fn, reset_fn, state, batches = _mplug_program(
        make_mesh() if with_mesh else None)
    step_fn(state, batches[0])  # step 0, unrecorded
    profiling.tracing(True)
    step_fn(state, batches[1])  # step 1
    reset_fn(state)
    recs = profiling.spans()
    want = list(MPLUG_TREE)
    if with_mesh:
        want.insert(7, ("grad_sync", 0))
    want.append(("reset", None))
    assert [(r.name, r.parent) for r in recs] == want
    assert {r.step for r in recs[:-1]} == {1} and recs[-1].step == 2
    # each span inside its parent, siblings in order and apart
    for i, r in enumerate(recs):
        assert r.host_start_ns <= r.host_end_ns
        if r.parent is not None:
            up = recs[r.parent]
            assert up.host_start_ns <= r.host_start_ns
            assert r.host_end_ns <= up.host_end_ns
    # siblings follow each other without overlap: the children tile their
    # parent up to the host's own work between them (on the card the
    # benchmark's traced run reads their device coverage of train_step)
    for parent in (0, 2):
        kids = [r for r in recs if r.parent == parent]
        assert all(a.host_end_ns <= b.host_start_ns
                   for a, b in zip(kids, kids[1:]))
    assert all(r.device_ms is None for r in recs)
