"""The benchmark's own FLOP count against the program's
(`crvqa_tpu_torch.utils.mfu.count_flops`) at the cells' shapes, and the
attention bounds' arithmetic.

The two counts differ by exactly the forward of LXMERT's last cross
layer's vision branch (its vision-to-language attention, vision
self-attention and vision FFN): the program computes it and nothing reads
it, so the benchmark's count leaves it out. VisualBERT has no such branch
and the counts agree."""
from __future__ import annotations

import pytest
import torch

from portbench.counts.attention import bound_s, call_cost
from portbench.counts.flops import _meta_batch, count_step
from portbench.families import lxmert, visualbert
from portbench.harness.cells import Benchmark

BENCH = Benchmark()
TRAFFIC = {"stage2-b2048": True, "answer-b2048": False}
CELLS = [("lxmert-base", "stage2-b2048"), ("visualbert-base", "stage2-b2048"),
         ("lxmert-base", "answer-b2048")]
FAMILIES = {"lxmert-base": lxmert, "visualbert-base": visualbert}


def dead_branch_flops(cfg: dict, b: int, sq: int, sv: int) -> int:
    """Forward FLOPs of LXMERT's last vision branch at b rows, sq tokens
    and sv boxes."""
    h, i, heads = cfg["hidden_size"], cfg["intermediate_size"], cfg[
        "num_attention_heads"]
    d = h // heads
    cross = (2 * b * sv * h * h + 2 * 2 * b * sq * h * h
             + 4 * b * heads * sv * sq * d + 2 * b * sv * h * h)
    self_att = 4 * 2 * b * sv * h * h + 4 * b * heads * sv * sv * d
    ffn = 2 * 2 * b * sv * h * i
    return cross + self_att + ffn


def program_count(name: str, traffic: str, batch: int) -> int:
    """The program's own count of one step (train) or eval forward, on a
    meta state at the configuration's widths."""
    from crvqa_tpu_torch.train import stage2
    from crvqa_tpu_torch.train.common import HfAdamW, TrainRNG
    from crvqa_tpu_torch.utils.mfu import count_flops

    from portbench.harness.program import Stage2Program

    cfg, trf = BENCH.config(name), BENCH.traffic(traffic)
    fam = FAMILIES[name]
    model = fam.meta_model(cfg, torch.bfloat16)
    masker = fam.masker(cfg)
    meta = lambda shape, grad=False: torch.zeros(
        shape, device="meta").requires_grad_(grad)
    params = {n: p for n, p in model.named_parameters()}
    pre = fam.CLASSIFIER_KEY + "."
    from crvqa_tpu_torch.masking.masker import weight_name

    scores = {s.key: meta(params[weight_name(s)].shape, True)
              for s in masker.specs}
    state = stage2.Stage2State(
        step=0, frozen={n: meta(p.shape) for n, p in params.items()
                        if not n.startswith(pre)},
        train_params={"classifier": {n[len(pre):]: meta(p.shape, True)
                                     for n, p in params.items()
                                     if n.startswith(pre)},
                      "lmh": {"bias_lin.weight": meta((1, cfg["hidden_size"])),
                              "bias_lin.bias": meta((1,)),
                              "smooth_param": meta((1,))}},
        scores=scores, thresholds={k: meta(()) for k in scores},
        opt_state=None, rng=TrainRNG.from_seed(0, "cpu"))
    config = stage2.Stage2Config(hidden_size=cfg["hidden_size"],
                                 classifier_key=fam.CLASSIFIER_KEY)
    tx = HfAdamW(1e-5)
    prog = Stage2Program(model, masker, config, state, tx,
                         fam.CLASSIFIER_KEY)
    state.opt_state = tx.init(stage2.trainable(state, config))
    batch = _meta_batch(fam, cfg, trf, batch)
    if TRAFFIC[traffic]:
        fn = stage2.make_train_step(model, masker, tx, config)
    else:
        fn = stage2.make_eval_step(model, masker, config)
    assert prog.trainable()
    return count_flops(fn, state, batch)


@pytest.mark.parametrize("name,traffic", CELLS)
def test_count_is_the_programs_less_the_dead_branch(name, traffic):
    cfg, trf = BENCH.config(name), BENCH.traffic(traffic)
    b = trf["batch_size"]
    ours, calls = count_step(FAMILIES[name], cfg, trf, TRAFFIC[traffic])
    theirs = program_count(name, traffic, b)
    dead = (dead_branch_flops(cfg, b, trf["question_tokens"]["max"],
                              trf["boxes"]) if name == "lxmert-base" else 0)
    assert theirs - ours == dead
    assert calls and all(c[5] == TRAFFIC[traffic] for c in calls)


def test_counts_are_linear_in_the_batch():
    cfg, trf = BENCH.config("lxmert-base"), BENCH.traffic("stage2-b2048")
    one, _ = count_step(lxmert, cfg, trf, True, batch=1)
    many, _ = count_step(lxmert, cfg, trf, True, batch=2048)
    assert many == 2048 * one


def test_lxmert_attention_calls():
    """32 calls a step: 9 language and 5 visual self-attentions, and per
    cross layer its two cross and two self-attentions, less the last
    layer's vision-to-language and vision self-attention."""
    cfg, trf = BENCH.config("lxmert-base"), BENCH.traffic("stage2-b2048")
    _, calls = count_step(lxmert, cfg, trf, True, batch=4)
    shapes = sorted((c[2], c[3]) for c in calls)
    assert len(calls) == 32
    assert shapes.count((14, 14)) == 9 + 5 and shapes.count((36, 36)) == 5 + 4
    assert shapes.count((14, 36)) == 5 and shapes.count((36, 14)) == 4


def test_attention_bound_arithmetic():
    call = (2048, 12, 36, 36, 64, True)
    flops, nbytes = call_cost(call, "forward", 2)
    assert flops == 4 * 2048 * 12 * 36 * 36 * 64
    qkv = 2048 * 36 * 768 * 2
    assert nbytes == 4 * qkv + 2048 * 36 * 4
    flops_b, bytes_b = call_cost(call, "backward", 2)
    assert flops_b == 2 * flops and bytes_b == nbytes + 3 * qkv
    peaks = {"bfloat16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert bound_s([call], ("forward",), 2, peaks) == pytest.approx(
        nbytes / 3.35e12)  # memory-bound at this shape
    assert bound_s([call[:5] + (False,)], ("forward", "backward"), 2,
                   peaks) == bound_s([call], ("forward",), 2, peaks)
