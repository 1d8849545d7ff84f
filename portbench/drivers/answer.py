"""Offline answering with a masked model: `train.evaluation.predict` over
`stage2.make_eval_step`, as the stage-2 CLI scores a split, on batches
kept on the device. The mask is the magnitude init reset to the
configuration's zero rates (`stage2.make_threshold_reset`).

`predict` fetches every batch's logits (and labels) to the host, so one
batch is in flight at a time. The window calls it on chunks of
`chunk_batches` batches cycled from the pool, so the logits do not pile up
on the host, and keeps `sample_rows` rows of every batch, drawn from the
seed, for the check. `answer_q_s`: the questions whose logits reached the
host in the window over its seconds. A traced run profiles the chunk
`profile.start` chunks into the window, after one in a discarded session.

The check holds every kept answer against the reference's logits of its
row: the window's answers of one pool batch are many, and each is judged.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.counts.flops import count_step
from portbench.harness.check import answer_readings
from portbench.harness.inputs import make_pool, make_weights, sub_seed
from portbench.harness.program import build_stage2
from portbench.harness.trace import profile
from portbench.reference.common import strict_fp32
from portbench.reference.stage2 import Stage2Reference


def reference_logits(run, pool_batches: set, prec=None) -> dict:
    """pool batch -> the reference's logits of all its rows, from inputs
    made again from the seed."""
    from portbench.reference.common import FP32

    strict_fp32()
    ref_mod = run.family.reference
    weights = make_weights(ref_mod.param_table(run.cfg), run.seed,
                           run.device)
    pool = make_pool(run.cfg, run.trf, run.family.STYLE, run.seed,
                     run.device)
    ref = Stage2Reference(ref_mod, run.cfg, run.trf, weights, run.seed,
                          prec or FP32)
    ref.reset()
    rows = run.trf["check"]["block_rows"]
    return {j: ref.logits(pool[j], rows).cpu() for j in sorted(pool_batches)}


def run(run) -> None:
    from crvqa_tpu_torch.train import stage2
    from crvqa_tpu_torch.train.evaluation import predict

    cfg, trf, fam, dev = run.cfg, run.trf, run.family, run.device
    sp = run.spans
    with sp("setup_inputs"):
        params = make_weights(fam.reference.param_table(cfg), run.seed, dev)
        pool = make_pool(cfg, trf, fam.STYLE, run.seed, dev)
    with sp("setup_program"):
        prog = build_stage2(fam, cfg, trf, params, run.seed, dev)
        del params
        state = stage2.make_threshold_reset(prog.masker)(prog.state)
        eval_fn = stage2.make_eval_step(prog.model, prog.masker, prog.config)
    batch, chunk = trf["batch_size"], trf["chunk_batches"]
    rng = np.random.default_rng(sub_seed(run.seed, "samples"))
    samples: list = []
    done = {"batches": 0, "answers": 0, "profiled_batches": 0,
            "profiled_s": 0.0}

    def one_chunk(keep: bool):
        first = done["batches"]
        js = [(first + i) % len(pool) for i in range(chunk)]
        with sp("predict"):
            out = predict(eval_fn, state, (pool[j] for j in js))
        logits = out["logits"]
        done["batches"] += chunk
        done["answers"] += logits.shape[0]
        if keep:
            for i, j in enumerate(js):
                rows = np.sort(rng.choice(batch, trf["sample_rows"],
                                          replace=False))
                block = logits[i * batch:(i + 1) * batch]
                picked = rows[rows < block.shape[0]]
                samples.append((j, torch.as_tensor(rows),
                                np.full((len(rows), cfg["ans_num"]), np.nan,
                                        np.float32)))
                samples[-1][2][:len(picked)] = block[picked]

    with sp("warmup"):
        one_chunk(keep=False)
    run.sync()
    run.reset_peak()
    run.e2e["setup_s"] = run.now() - run.t0
    done.update(batches=0, answers=0)
    prof = trf["profile"]
    t_start = run.now()
    deadline = t_start + run.seconds
    chunks = 0
    while True:
        if run.traced and run.profile is None and chunks == prof["start"]:
            t_p = run.now()
            run.profile = profile(lambda: one_chunk(keep=True),
                                  lambda: one_chunk(keep=True), dev)
            done["profiled_s"] += run.now() - t_p
            done["profiled_batches"] += 2 * chunk
        else:
            one_chunk(keep=True)
        chunks += 1
        if run.now() >= deadline:
            break
    run.sync()
    window_s = run.now() - t_start
    run.e2e["answer_q_s"] = done["answers"] / window_s
    run.e2e["peak_gib"] = run.peak() / 2 ** 30
    run.reset_peak()
    sent = done["batches"] * batch
    run.attempted = sent
    run.failed = sent - done["answers"]
    if run.traced:
        flops, calls = count_step(fam, cfg, trf, train=False)
        run.counters.update(
            flops_per_batch=flops, attention_calls=calls,
            batches=done["batches"] - done["profiled_batches"],
            window_s=window_s - done["profiled_s"],
            profiled_steps=chunk)
    del state, prog, pool, eval_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_logits(run, {j for j, _, _ in samples})
    run.readings = answer_readings(samples, ref, sent - done["answers"])
