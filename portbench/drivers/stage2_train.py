"""Stage-2 mask training as `crvqa_tpu_torch/cli/prune_debias_vqa.py` runs
it: `stage2.make_train_step` on batches kept on the device, and at every
crossing of `logging_steps` the CLI's block (`make_threshold_reset`, two
`mask_drift`s, `binary_masks`, the loss read).

Set-up builds one program state and drives it through the first
`check.steps` steps with the window's own call, on distinct batches of the
pool; their outputs (the losses, the first clipped gradient as the
optimizer's first moments hold it, the change of every leaf) and the
thresholds of one reset block after them are what the check holds against
the reference. The window then goes on with that same state, cycling the
pool, for `--seconds`, and ends at a synchronisation.

`train_ex_s`: the window's examples over its seconds, its resets, drifts
and loss reads included. `peak_gib`: the device's peak allocation in the
window. A traced run profiles `profile.steps` steps from `profile.start`
steps into the window (after one step in a discarded session) and
synchronises around each reset (`reset` spans).
"""
from __future__ import annotations

import gc
import math

import torch

from portbench.counts.flops import count_step
from portbench.harness.check import training_readings
from portbench.harness.inputs import make_pool, make_weights
from portbench.harness.program import build_stage2
from portbench.harness.trace import profile
from portbench.reference.common import strict_fp32
from portbench.reference.stage2 import Stage2Reference, norms


def crossed(step: int, prev: int, every: int) -> bool:
    return bool(every) and step // every > prev // every


def program_outputs(run, prog, step_fn, reset_block, pool) -> dict:
    """Drive the program through the checked steps and one reset block;
    return what it produced."""
    n = run.trf["check"]["steps"]
    p0 = {k: v.detach().clone() for k, v in prog.trainable().items()}
    losses, grad, metrics = [], None, None
    state = prog.state
    for i in range(n):
        with run.spans("check_step"):
            state, metrics = step_fn(state, pool[state.step % len(pool)])
        losses.append(metrics.loss.detach().clone())
        if i == 0:
            # the first moments after one step: (1 - b1) * g
            grad = {k: float(torch.linalg.vector_norm(v.double()))
                    / (1.0 - prog.tx.b1)
                    for k, v in prog.first_moments().items()}
    change = {k: float((v.detach() - p0[k]).double().norm())
              for k, v in prog.trainable().items()}
    del p0
    with run.spans("check_reset"):
        state = reset_block(state, metrics)
    thresholds = {k: float(v) for k, v in prog.thresholds().items()}
    return {"losses": [float(x) for x in losses], "grad": grad,
            "change": change, "thresholds": thresholds}


def reference_outputs(run, prec=None) -> dict:
    """The same outputs from the plain reference, on inputs made again
    from the seed, in float32 (or `prec`)."""
    from portbench.reference.common import FP32

    strict_fp32()
    ref_mod = run.family.reference
    weights = make_weights(ref_mod.param_table(run.cfg), run.seed,
                           run.device)
    pool = make_pool(run.cfg, run.trf, run.family.STYLE, run.seed,
                     run.device)
    ref = Stage2Reference(ref_mod, run.cfg, run.trf, weights, run.seed,
                          prec or FP32)
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


def run(run) -> None:
    from crvqa_tpu_torch.train import stage2

    cfg, trf, fam, dev = run.cfg, run.trf, run.family, run.device
    sp = run.spans
    with sp("setup_inputs"):
        params = make_weights(fam.reference.param_table(cfg), run.seed, dev)
        pool = make_pool(cfg, trf, fam.STYLE, run.seed, dev)
    with sp("setup_program"):
        prog = build_stage2(fam, cfg, trf, params, run.seed, dev)
        del params
        masker = prog.masker
        step_fn = stage2.make_train_step(prog.model, masker, prog.tx,
                                         prog.config)
        reset_fn = stage2.make_threshold_reset(masker)
        orig = masker.binary_masks(prog.state.scores, prog.state.thresholds)
    tmp = [orig]

    def reports(state, metrics):
        masker.mask_drift(state.scores, state.thresholds, orig)
        masker.mask_drift(state.scores, state.thresholds, tmp[0])
        tmp[0] = masker.binary_masks(state.scores, state.thresholds)
        return float(metrics.loss)

    def reset_block(state, metrics):
        state = reset_fn(state)
        reports(state, metrics)
        return state

    prog_out = program_outputs(run, prog, step_fn, reset_block, pool)
    run.sync()
    run.reset_peak()
    run.e2e["setup_s"] = run.now() - run.t0

    every, batch = trf["logging_steps"], trf["batch_size"]
    state = prog.state
    done = {"steps": 0, "profiled_steps": 0, "profiled_s": 0.0,
            "metrics": None}

    def one_step():
        prev = state.step
        with sp("step"):
            _, m = step_fn(state, pool[state.step % len(pool)])
        done["metrics"] = m
        done["steps"] += 1
        if crossed(state.step, prev, every):
            with sp("reset", sync=run.traced):
                reset_fn(state)
            with sp("reset_reports"):
                reports(state, m)

    prof = trf["profile"]
    t_start = run.now()
    deadline = t_start + run.seconds
    while True:
        if (run.traced and run.profile is None
                and done["steps"] == prof["start"]):
            t_p = run.now()
            run.profile = profile(
                one_step, lambda: [one_step() for _ in range(prof["steps"])],
                dev)
            done["profiled_s"] += run.now() - t_p
            done["profiled_steps"] += prof["steps"] + 1
        else:
            one_step()
        if run.now() >= deadline:
            break
    run.sync()
    window_s = run.now() - t_start
    last_loss = float(done["metrics"].loss)
    run.e2e["train_ex_s"] = done["steps"] * batch / window_s
    run.e2e["peak_gib"] = run.peak() / 2 ** 30
    run.reset_peak()
    run.attempted = done["steps"]
    run.failed = 0 if math.isfinite(last_loss) else 1
    if run.traced:
        flops, calls = count_step(fam, cfg, trf, train=True)
        run.counters.update(
            flops_per_step=flops, attention_calls=calls,
            steps=done["steps"] - done["profiled_steps"],
            window_s=window_s - done["profiled_s"],
            profiled_steps=prof["steps"],
            resets_s=sp.named("reset"))
    del state, prog, pool, step_fn, reset_fn, orig, tmp, done
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.readings = training_readings(prog_out, reference_outputs(run))
