"""Stage-1 driver: dense fine-tuning of LXMERT on VQA-CP v2 with a debias
loss (counterpart of `crvqa_tpu/cli/run_vqa_stage1.py`; same argv plus
`--device`).

    python -m crvqa_tpu_torch.cli.run_vqa_stage1 --output_dir out \\
        --dataroot DATA --img_root FEATS --vocab_file vocab.txt \\
        --FT_type lmh --train_batch_size 64 --do_train \\
        --evaluate_during_training

Starts from `--init_ckpt` (a torch .bin/.pt state_dict or module pickle,
or the JAX package's msgpack params file; seeded init without one), trains
every parameter under `--FT_type`'s loss with the clipped Adam of
`train/stage1.py`, checkpoints every `--save_steps` (`ckpt_<step>`, the
port's torch format, keep 2; resumable with `--resume_from`, which also
takes the JAX CLI's msgpack `ckpt_<step>`, `common.resume_any`) and, with
`--evaluate_during_training`, evaluates there, writing `test.json` and the
parameters as `<label4save>_FT{only,lmh_only,lpf_only,rubi_only}.bin` with
its `.msgpack` twin (the JAX package's params file) at each new best (the
final parameters when no evaluation ran). `--dataset vqavs` trains on the
VQA-VS files. Step metrics go to `metrics.jsonl` (and
`--tensorboard_dir`, `--wandb_project`); `--profile_dir` traces a step
window (`common.ProfileWindow`). Runs on the card (`--device cuda`, the
default, raising without one); `--device cpu` runs the kernels' plain
versions.

Not yet ported (raise when set away from their defaults): `--mesh_*`,
`--multihost`. `--model_type` other than lxmert raises too: the JAX CLI
parses it and never reads it, building LXMERT whatever it says
(`common.reject_model_type`).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..core import checkpoint as ckpt
from ..core import torch_compat
from ..device import resolve_device
from ..models import LxmertConfig
from ..train import stage1
from ..train.evaluation import dump_predictions, predict, vqa_accuracy
from ..train.stage2 import lxmert_meta_model
from . import common

UNPORTED = common.COMMON_UNPORTED

_SUFFIX = {"normal": "_FTonly.bin", "lmh": "_FTlmh_only.bin",
           "lpf": "_FTlpf_only.bin", "rubi": "_FTrubi_only.bin"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_vqa_stage1")
    common.add_common_args(p)
    p.add_argument("--model_type", type=str, default="lxmert",
                   help=common.MODEL_TYPE_HELP)
    p.add_argument("--FT_type", type=str, default="normal",
                   choices=["normal", "lmh", "lpf", "rubi"])
    p.add_argument("--training_type", type=str, default="FTonly")
    p.add_argument("--init_ckpt", type=str, default=None,
                   help="pretrained LXMERT weights (torch .bin/.pt/.pth, "
                        "or a msgpack params file)")
    common.add_dense_train_flags(p)
    return p


def lxmert_config(args, **overrides) -> LxmertConfig:
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    kw = dict(common.config_overrides(args), **overrides)
    return (LxmertConfig.tiny(dtype=dtype, **kw) if args.tiny
            else LxmertConfig(ans_num=args.ans_num, dtype=dtype, **kw))


def stage1_config(args, config: LxmertConfig, n_train: int
                  ) -> stage1.Stage1Config:
    return stage1.Stage1Config(
        ft_type=args.FT_type, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        total_steps=common.scheduler_horizon(
            n_train, args.train_batch_size, args.num_train_epochs),
        max_grad_norm=args.max_grad_norm, adam_epsilon=args.adam_epsilon,
        gamma=args.gamma, hidden_size=config.hidden_size,
        grad_accum_steps=args.gradient_accumulation_steps,
        moment_dtype=args.moment_dtype)


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


def run(args) -> dict:
    """The stage-1 run; returns a summary: final step, every step's loss,
    best and final eval accuracy, the saved parameters' path (`bin`) and
    the final training state (`state`)."""
    common.reject_model_type(args, "run_vqa_stage1")
    common.reject_unported(args, UNPORTED)
    device = resolve_device(args.device)
    common.setup_logging(args.output_dir)
    common.dump_args(args, args.output_dir)
    config = lxmert_config(args)
    params = common.lxmert_initial_params(config, args.seed, args.init_ckpt)
    bin_path = os.path.join(args.output_dir,
                            args.label4save + _SUFFIX[args.FT_type])
    return train_and_evaluate(args, config, params, None, device, bin_path)


def train_and_evaluate(args, config: LxmertConfig,
                       params: dict[str, torch.Tensor], masks, device,
                       bin_path: str, specs=()) -> dict:
    """The stage-1/3 loop shared by both drivers (`run_vqa_stage1.py` /
    `run_vqa_stage3.py` of the JAX package): train with logging, periodic
    checkpoints and evaluations, the best parameters to `bin_path`, then
    the final evaluation. `masks` (stage 3) are the constant masks by
    weight name, or None; `specs` the masker's that keyed them (a JAX
    `--resume_from` keys its masks by spec). Each save writes `bin_path` and, for the JAX
    package, `bin_path + ".msgpack"`."""
    common.init_metrics(args)
    train_batches, eval_batches, label2ans, n_train = common.build_data(
        args, config, device)
    cfg = stage1_config(args, config, n_train)
    state, tx = stage1.init_state(params, cfg, args.seed, device, masks=masks)
    del params
    if args.resume_from:
        common.resume_any(args.resume_from, state, "stage1", cfg, specs)
    model = lxmert_meta_model(config)
    step_fn = stage1.make_train_step(model, cfg, tx)
    eval_fn = stage1.make_eval_step(model)
    summary: dict = {"losses": [], "best_acc": None, "eval_acc": None,
                     "bin": bin_path, "trace": None}

    def evaluate(state):
        out = predict(eval_fn, state, eval_batches())
        return vqa_accuracy(out["logits"], out["labels"]), out

    def save_best(state):
        torch_compat.save_torch_state_dict(bin_path, state.params)
        common.save_params_msgpack(bin_path + ".msgpack", state.params,
                                   model)

    best = -1.0
    losses = []
    if args.do_train:
        step = state.step
        t_last, s_last = time.perf_counter(), step
        guard = common.PreemptionGuard()
        profiler = common.ProfileWindow(args)
        for epoch in range(int(args.num_train_epochs)):
            for batch in train_batches(epoch):
                state, metrics = step_fn(state, batch)
                losses.append(metrics.loss)
                prev, step = step, state.step
                profiler.tick(step)
                if common.crossed(step, prev, args.logging_steps):
                    now = time.perf_counter()
                    ex_s = ((step - s_last) * args.train_batch_size
                            / max(now - t_last, 1e-9))
                    t_last, s_last = now, step
                    common.log_step(step, loss=float(metrics.loss),
                                    score=100 * float(metrics.score)
                                    / metrics.batch_size, epoch=epoch,
                                    ex_s=round(ex_s, 1))
                if common.crossed(step, prev, args.save_steps):
                    ckpt.save_stage1_checkpoint(
                        os.path.join(args.output_dir, f"ckpt_{step}"), state,
                        metadata={"step": step})
                    ckpt.rotate_checkpoints(args.output_dir, keep=2)
                    if args.evaluate_during_training:
                        acc, out = evaluate(state)
                        common.log_step(step, eval_acc=acc)
                        if acc > best:
                            best = acc
                            dump_predictions(
                                os.path.join(args.output_dir, "test.json"),
                                out["logits"], out["question_id"], label2ans)
                            save_best(state)
                if guard.triggered:
                    path = os.path.join(args.output_dir, f"ckpt_{step}")
                    ckpt.save_stage1_checkpoint(path, state, metadata={
                        "step": step, "preempted": True})
                    common.log_step(step, preempted=True, checkpoint=path)
                    profiler.close()
                    summary.update(step=step,
                                   losses=[float(x) for x in losses])
                    return summary
        profiler.close()
        summary["trace"] = profiler.path
        if best < 0:
            # no best-eval save fired: keep the final parameters, and
            # never overwrite a best-eval save with them
            save_best(state)
        else:
            # `best_eval_results_vqa_noMASK.txt` (run_vqa_stage1.py:615-623)
            common.write_eval_results(args.output_dir,
                                      "best_eval_results_vqa_noMASK.txt",
                                      eval_acc=best)

    if args.do_eval or args.do_predict:
        acc, out = evaluate(state)
        common.log_step(state.step, final_eval_acc=acc)
        common.write_eval_results(args.output_dir, "eval_results_vqa.txt",
                                  eval_acc=acc)
        summary["eval_acc"] = acc
        # the reference never rewrites the best-save test.json after training
        if not os.path.exists(os.path.join(args.output_dir, "test.json")):
            dump_predictions(os.path.join(args.output_dir, "test.json"),
                             out["logits"], out["question_id"], label2ans)
    summary.update(step=state.step, losses=[float(x) for x in losses],
                   best_acc=best if best >= 0 else None, state=state)
    return summary


if __name__ == "__main__":
    main()
