"""mPLUG mask training as `crvqa_tpu_torch/cli/vqa_mplug.py` runs it:
`mplug_train.make_train_step` (the CLI's mesh and one-rank ZeRO
partition) on batches kept on the device, and at every crossing of
`masker_update_step` the CLI's block (the scheduler's target,
`make_threshold_reset`, the sparsity report), at every crossing of
`logging_steps` the loss read.

Set-up builds one program state (`families/mplug.build`) and drives it
through the first `check.steps` steps with the window's own call, on
distinct batches of the pool; their outputs (the losses, the first
clipped gradient as the optimizer's first moments hold it, the change of
every score and LM-head leaf) and the thresholds of one reset block after
them are what the check holds against the reference. The window then
goes on with that same state, cycling the pool, for `--seconds`, and
ends at a synchronisation.

`train_ex_s`: the window's questions over its seconds, its resets and
reads included. `peak_gib`: the device's peak allocation in the window.
A traced run profiles `profile.steps` steps from `profile.start` steps
into the window (after one step in a discarded session), records the
program's spans over those steps (`utils/profiling.tracing`; their device
ms a step go into `counters['span_ms']`, empty where the program has no
such span) and synchronises around each reset (`reset` spans).
"""
from __future__ import annotations

import gc
import math
import sys

import torch

from portbench.counts.mplug import count_step
from portbench.harness.check import training_readings
from portbench.harness.inputs import make_weights
from portbench.harness.mplug_inputs import make_pool
from portbench.harness.trace import profile
from portbench.reference.common import FP32, strict_fp32
from portbench.reference.mplug import MPlugReference
from portbench.reference.stage2 import norms


def crossed(step: int, prev: int, every: int) -> bool:
    return bool(every) and step // every > prev // every


def program_outputs(run, prog, step_fn, reset_block, pool) -> dict:
    """Drive the program through the checked steps and one reset block;
    return what it produced."""
    from crvqa_tpu_torch.train.common import GroupAdamW

    b1 = GroupAdamW({}, {}, {}).b1
    p0 = {k: v.detach().clone() for k, v in prog.trainable().items()}
    losses, grad = [], None
    state = prog.state
    for i in range(run.trf["check"]["steps"]):
        with run.spans("check_step"):
            state, loss = step_fn(state, pool[state.step % len(pool)])
        losses.append(loss.detach().clone())
        if i == 0:
            # the first moments after one step: (1 - b1) * g
            grad = {k: float(torch.linalg.vector_norm(v.double())) / (1 - b1)
                    for k, v in prog.first_moments().items()}
    change = {k: float((v.detach() - p0[k]).double().norm())
              for k, v in prog.trainable().items()}
    del p0
    with run.spans("check_reset"):
        reset_block(state, losses[-1])
    thresholds = {k: float(v) for k, v in prog.thresholds().items()}
    return {"losses": [float(x) for x in losses], "grad": grad,
            "change": change, "thresholds": thresholds}


def reference_outputs(run, prec=None) -> dict:
    """The same outputs from the plain reference, on inputs made again
    from the seed, in float32 (or `prec`)."""
    strict_fp32()
    ref_mod = run.family.reference
    weights = make_weights(ref_mod.param_table(run.cfg), run.seed,
                           run.device)
    pool = make_pool(run.cfg, run.trf, run.seed, run.device)
    ref = MPlugReference(run.cfg, run.family.optimizer_settings(run.trf),
                         weights, run.seed, prec or FP32)
    check = run.trf["check"]
    p0 = {k: v.clone() for k, v in ref.trainable().items()}
    losses, grad = [], None
    for i in range(check["steps"]):
        loss, grads = ref.step(pool[i % len(pool)], check["block_rows"])
        losses.append(loss)
        if i == 0:
            grad = norms(grads)
        del grads
    change = norms({k: v - p0[k] for k, v in ref.trainable().items()})
    thresholds = {k: float(v) for k, v in ref.reset().items()}
    return {"losses": losses, "grad": grad, "change": change,
            "thresholds": thresholds}


def span_ms(records) -> dict:
    """Device ms a step of each span name, over the recorded steps (the
    `train_step` roots); empty without them or off the card."""
    steps = sum(r.name == "train_step" and r.parent is None
                for r in records)
    out: dict = {}
    for r in records:
        if r.device_ms is None:
            return {}
        out[r.name] = out.get(r.name, 0.0) + r.device_ms
    return {k: v / steps for k, v in out.items()} if steps else {}


def tiling(records) -> float:
    """The share of the `train_step` spans' device time that their
    direct children cover."""
    roots = {i for i, r in enumerate(records) if r.name == "train_step"}
    whole = sum(records[i].device_ms or 0.0 for i in roots)
    parts = sum(r.device_ms or 0.0 for r in records if r.parent in roots)
    return parts / whole if whole else 0.0


def run(run) -> None:
    from crvqa_tpu_torch.train import mplug_train
    from crvqa_tpu_torch.utils import profiling

    cfg, trf, fam, dev = run.cfg, run.trf, run.family, run.device
    sp = run.spans
    with sp("setup_inputs"):
        params = make_weights(fam.reference.param_table(cfg), run.seed, dev)
        pool = make_pool(cfg, trf, run.seed, dev)
    with sp("setup_program"):
        prog = fam.build(cfg, trf, params, run.seed, dev)
        del params
        fam.check_settings(prog, fam.optimizer_settings(trf))
        masker = prog.masker
        step_fn = mplug_train.make_train_step(
            prog.model, prog.config, masker=masker, mesh=prog.mesh,
            zero=prog.zero)
        reset_fn = mplug_train.make_threshold_reset(masker)

    def reset_block(state, loss):
        """The CLI's block at a `masker_update_step` crossing: the
        scheduler's target at the fractional epoch, the reset, the
        achieved zero rate read back."""
        epoch = (state.step - 1) / prog.steps_per_epoch
        _, target, _ = prog.scheduler.step(epoch)
        reset_fn(state, float(target))
        masker.sparsity_report(state.scores, state.thresholds)

    prog_out = program_outputs(run, prog, step_fn, reset_block, pool)
    run.sync()
    run.reset_peak()
    run.e2e["setup_s"] = run.now() - run.t0

    every, log_every = trf["masker_update_step"], trf["logging_steps"]
    state = prog.state
    done = {"steps": 0, "profiled_steps": 0, "profiled_s": 0.0,
            "loss": None}

    def one_step():
        prev = state.step
        with sp("step"):
            _, loss = step_fn(state, pool[state.step % len(pool)])
        done["loss"] = loss
        done["steps"] += 1
        if crossed(state.step, prev, every):
            with sp("reset", sync=run.traced):
                epoch = (state.step - 1) / prog.steps_per_epoch
                _, target, _ = prog.scheduler.step(epoch)
                reset_fn(state, float(target))
            with sp("reset_reports"):
                masker.sparsity_report(state.scores, state.thresholds)
        if crossed(state.step, prev, log_every):
            float(loss)

    def recorded_steps():
        profiling.clear()
        profiling.tracing(True)
        try:
            for _ in range(prof["steps"]):
                one_step()
        finally:
            profiling.tracing(False)

    prof = trf["profile"]
    records = []
    t_start = run.now()
    deadline = t_start + run.seconds
    while True:
        if (run.traced and run.profile is None
                and done["steps"] == prof["start"]):
            t_p = run.now()
            run.profile = profile(one_step, recorded_steps, dev)
            records = profiling.spans()
            profiling.clear()
            done["profiled_s"] += run.now() - t_p
            done["profiled_steps"] += prof["steps"] + 1
        else:
            one_step()
        if run.now() >= deadline:
            break
    run.sync()
    window_s = run.now() - t_start
    last_loss = float(done["loss"])
    run.e2e["train_ex_s"] = done["steps"] * trf["batch_size"] / window_s
    run.e2e["peak_gib"] = run.peak() / 2 ** 30
    run.reset_peak()
    run.attempted = done["steps"]
    run.failed = 0 if math.isfinite(last_loss) else 1
    if run.traced:
        flops, calls = count_step(cfg, trf)
        ms = span_ms(records)
        run.counters.update(
            flops_per_step=flops, attention_calls=calls,
            steps=done["steps"] - done["profiled_steps"],
            window_s=window_s - done["profiled_s"],
            profiled_steps=prof["steps"],
            resets_s=sp.named("reset"), span_ms=ms)
        if ms:
            print("spans (device ms a step): " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items())
                  + f"; children tile {100 * tiling(records):.3f}% of "
                    "train_step", file=sys.stderr)
    del state, prog, pool, step_fn, reset_fn, done, records
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.readings = training_readings(prog_out, reference_outputs(run))
