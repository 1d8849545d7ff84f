"""Stage-2 driver: mask-train LXMERT on VQA-CP v2 with per-modality sparsity
(counterpart of `crvqa_tpu/cli/prune_debias_vqa.py`; same argv plus
`--device`).

    python -m crvqa_tpu_torch.cli.prune_debias_vqa --output_dir out \\
        --dataroot DATA --img_root FEATS --vocab_file vocab.txt \\
        --train_batch_size 256 --do_train --evaluate_during_training

Loads the stage-1 checkpoint (`--stage1_ckpt`: a torch .bin/.pt, or the
JAX package's msgpack params file; seeded init without one), reads VQA-CP
or (`--dataset vqavs`, or `prune_debias_vqavs`) VQA-VS, builds the
per-modality Masker, trains the mask scores and the classifier with the
`--Masker_type` debias loss, resets the thresholds every
`--logging_steps`, checkpoints and (with
`--evaluate_during_training`) evaluates every `--save_steps`, and at each
new best writes `test.json`, `mask.pt` and `classifier4masker.bin` in the
JAX CLI's formats. `--structured_masking heads|layers` trains one gate per
attention head or per matrix of the specs `--structured_masking_types`
selects (`masking/structured.py`); `mask.pt` carries the gates expanded
to their weights and, with `heads`, `head_mask.npy` the language layers'
[L, H] head mask for stage 3's `--head_mask_npy`. Step metrics go to
`metrics.jsonl` (and `--tensorboard_dir`, `--wandb_project`);
`--profile_dir` traces a step window (`common.ProfileWindow`). Runs on
the card (`--device cuda`, the default, raising without one); `--device
cpu` runs the kernels' plain versions.

`--resume_from` takes a `ckpt_<step>` of this port or of the JAX
package's stage-2 CLI (`common.resume_any`; the JAX state's backbone
replaces the --seed / --stage1_ckpt one, as its own resume does).

`--multihost true` runs one process per device (`parallel/`, launched by
torchrun or with `--coordinator_address/--num_processes/--process_id`):
`--mesh_data` ranks each train on their block of every global batch,
with the gradients averaged over them; `--zero_opt true` shards the Adam
state over them (`parallel/zero.py`); `--mesh_model` > 1 splits the
attention heads, the FFN units and their mask scores over that many
ranks (`parallel/tp.py`, Megatron-style, as the JAX CLI applies
`shard_params_tp`); `--structured_masking` gates stay whole on every
rank, as the JAX rule replicates them. Checkpoints and exports are
collective and written by rank 0.

`--steps_per_dispatch N` > 1 trains in windows of N batches
(`stage2.make_multi_step`; each rank stacks its own block of each): the
step count advances by N, resets, logs and checkpoints fire once for each
multiple of their interval a window crosses, a window logs its last
step's loss, `--profile_dir` ticks once a window, a preemption drops the
batches of an unfinished window, and at the end of each epoch the
batches left over go through single steps. Every step's loss is kept.

`--scan_layers true` trains the scan layout (`models/lxmert_scan.py`):
the stage-1 weights load in the unrolled layout and are stacked, and the
state holds stacked weights, scores and moments and per-layer thresholds,
as the JAX scan state does, so either package's `ckpt_<step>` of such a
run resumes. As in the JAX CLI, `--layers_to_mask` is ignored under it
and every layer is masked. `--structured_masking` with it raises as the
JAX CLI does (a TypeError before the first step: a gate's threshold over
a stacked group). Under `--mesh_model` > 1 its stacked leaves stay whole
on every rank, as the JAX rule replicates 3-D leaves: each model rank
runs the whole model.

`--model_type` other than lxmert raises: the JAX CLI parses it and never
reads it, building LXMERT whatever it says (`common.reject_model_type`).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import torch_compat
from ..device import resolve_device
from ..masking.masker import Masker
from ..masking.sparsity_control import ModalSparsity
from ..masking.spec import lxmert_mask_specs, lxmert_scan_mask_specs
from ..masking.structured import (StructuredMasker, lang_head_mask,
                                  weight_masks)
from ..models import LxmertConfig
from ..parallel.mesh import is_main_process
from ..train import stage2
from ..train.evaluation import dump_predictions, predict, vqa_accuracy
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("prune_debias_vqa")
    common.add_common_args(p)
    p.add_argument("--model_type", type=str, default="lxmert",
                   help=common.MODEL_TYPE_HELP)
    p.add_argument("--masker_level", type=str, default="modal",
                   choices=["modal"])
    p.add_argument("--Lang_comp", type=float, default=0.3)
    p.add_argument("--Vis_comp", type=float, default=0.3)
    p.add_argument("--Fus_comp", type=float, default=0.3)
    p.add_argument("--zero_rate", type=float, default=0.7)
    p.add_argument("--FTmodel_type", type=str, default="noFT",
                   choices=["noFT", "normal", "lmh", "lpf", "rubi"])
    p.add_argument("--Masker_type", type=str, default="lmh",
                   choices=["normal", "lmh", "lpf", "rubi", "poe",
                            "reweight"])
    p.add_argument("--stage1_ckpt", type=str, default=None,
                   help="stage-1 checkpoint (torch .bin/.pt state_dict or "
                        "module pickle, or a msgpack params file)")
    p.add_argument("--controlled_init", type=str, default="magnitude",
                   choices=["magnitude", "uniform", "double_uniform",
                            "magnitude_soft", "magnitude_global", "none"])
    p.add_argument("--threshold", type=float, default=1e-2)
    p.add_argument("--init_scale", type=float, default=2e-2)
    p.add_argument("--global_prune", type=common.str2bool, default=False)
    p.add_argument("--name_of_masker", type=str, default="MaskedLinear1")
    common.add_moment_dtype_flag(p)
    p.add_argument("--mask_biases", type=common.str2bool, default=False)
    p.add_argument("--training_type", type=str, default="Masker")
    p.add_argument("--masking_scheduler_conf", type=str,
                   default="lambdas_lr=0,sparsity_warmup=automated_gradual_"
                           "sparsity,sparsity_warmup_interval_epoch=0.1,"
                           "init_epoch=0,final_epoch=1",
                   help="parsed for flag parity; like the reference stage-2 "
                        "trainer, not consulted")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--accumulate_grads", type=common.str2bool, default=False,
                   help="integrate |grad| per step (the reference AdamW's "
                        "state['sum']); dumped as grad_abs_sum.npz")
    p.add_argument("--scan_layers", type=common.str2bool, default=False,
                   help="the scan layout: stacked layer groups, per-layer "
                        "thresholds (models/lxmert_scan.py); every layer "
                        "is masked")
    p.add_argument("--layers_to_mask", type=str,
                   default="0,1,2,3,4,5,6,7,8,9,10,11")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help=">1 trains in windows of N steps "
                        "(stage2.make_multi_step); logging granularity "
                        "becomes N steps")
    p.add_argument("--zero_opt", type=common.str2bool, default=False,
                   help="shard the Adam state of the trainable leaves over "
                        "the data-parallel ranks (parallel/zero.py)")
    p.add_argument("--structured_masking", type=str, default="none",
                   choices=["none", "heads", "layers"])
    p.add_argument("--structured_masking_types", type=str, default="self",
                   help="comma-separated module-name substrings to mask "
                        "structurally (the reference's "
                        "structured_masking_types); others stay unstructured")
    return p


def initial_params(args, config: LxmertConfig) -> dict[str, torch.Tensor]:
    """fp32 params: a seeded init from --seed, overlaid by --stage1_ckpt
    (the `FTmodel_type` loading switch, prune_debias_VQA.py:767-818)."""
    return common.lxmert_initial_params(config, args.seed, args.stage1_ckpt)


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


def run(args) -> dict:
    """The stage-2 run; returns a summary: final step, every step's loss,
    best eval accuracy, the zero rates of the last export, the trace
    `--profile_dir` wrote (`trace`) and the final state (`state`)."""
    common.init_distributed(args)
    common.reject_model_type(args, "prune_debias_vqa")
    device = resolve_device(args.device)
    mesh = common.make_run_mesh(args, device)
    common.setup_logging(args.output_dir)
    common.dump_args(args, args.output_dir)
    common.init_metrics(args)
    common.dict_parser(args.masking_scheduler_conf)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    overrides = common.config_overrides(args)
    config = (LxmertConfig.tiny(dtype=dtype, **overrides) if args.tiny
              else LxmertConfig(ans_num=args.ans_num, dtype=dtype,
                                **overrides))
    params = initial_params(args, config)
    if args.scan_layers:
        from ..models.lxmert_scan import stack_params

        # the stage-1 weights load unrolled, then stack
        params = stack_params(params, config)
        specs = lxmert_scan_mask_specs(config.l_layers, config.r_layers,
                                       config.x_layers)
    else:
        layers = [int(x) for x in args.layers_to_mask.split(",")
                  if x.strip()]
        specs = lxmert_mask_specs(config.l_layers, config.r_layers,
                                  config.x_layers, layers_to_mask=layers)
    sparsity = ModalSparsity.from_compression(
        args.Lang_comp, args.Vis_comp, args.Fus_comp, args.zero_rate)
    masker_kw = dict(
        mask_biases=args.mask_biases, threshold=args.threshold,
        init_scale=args.init_scale,
        controlled_init=(None if args.controlled_init == "none"
                         else args.controlled_init),
        binarizer_name=args.name_of_masker, global_prune=args.global_prune)
    if args.structured_masking != "none":
        masker = StructuredMasker.create(
            specs, sparsity, structured_masking=args.structured_masking,
            structured_types=tuple(
                t for t in args.structured_masking_types.split(",") if t),
            num_heads=config.num_attention_heads, **masker_kw)
    else:
        masker = Masker.create(specs, sparsity, **masker_kw)

    train_batches, eval_batches, label2ans, n_train = common.build_data(
        args, config, device, mesh)
    cfg = stage2.Stage2Config(
        masker_type=args.Masker_type, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        total_steps=common.scheduler_horizon(
            n_train, args.train_batch_size, args.num_train_epochs),
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        adam_epsilon=args.adam_epsilon, gamma=args.gamma,
        hidden_size=config.hidden_size,
        grad_accum_steps=args.gradient_accumulation_steps,
        accumulate_abs_grad=args.accumulate_grads,
        backbone_dtype=args.backbone_dtype, moment_dtype=args.moment_dtype)
    model = stage2.lxmert_meta_model(config, scan=args.scan_layers)
    state, tx = stage2.init_state(model, masker, params, cfg, args.seed,
                                  device)
    del params
    if args.resume_from:
        # before the optimizer state is sharded: the file holds all of it
        common.resume_any(args.resume_from, state, "stage2", cfg,
                          masker.specs)
    from ..parallel.tp import enable_tp, tensor_parallel

    tp = tensor_parallel(mesh, state.frozen, masker.specs,
                         config.num_attention_heads, state.scores)
    if tp is not None:
        # after the resume: the file holds whole leaves
        enable_tp(model, tp)
        stage2.shard_state_tp(state, tp)
    zero = None
    if args.zero_opt:
        from ..parallel import zero_optimizer

        tx, zero = zero_optimizer(tx, stage2.trainable(state, cfg), mesh)
        state.opt_state = zero.shard_state(state.opt_state)
    spd = max(args.steps_per_dispatch, 1)
    if spd > 1:
        multi_fn = stage2.make_multi_step(model, masker, tx, cfg, spd, mesh,
                                          tp)
    step_fn = stage2.make_train_step(model, masker, tx, cfg, mesh, tp)
    reset_fn = stage2.make_threshold_reset(masker, tp)
    eval_fn = stage2.make_eval_step(model, masker, tp=tp)
    summary: dict = {"losses": [], "best_acc": None, "zero_rates": None,
                     "trace": None}

    def save(path: str, metadata: dict) -> None:
        ckpt.save_checkpoint(path, state, metadata, zero=zero, tp=tp)

    def evaluate(state):
        out = predict(eval_fn, state, eval_batches(), mesh)
        return vqa_accuracy(out["logits"], out["labels"]), out

    def export_best(state):
        state = reset_fn(state)
        scores = stage2.full_scores(state, tp)
        masks = masker.binary_masks(scores, state.thresholds)
        # mask.pt carries weight-shaped masks: structured gates expanded
        # over the whole weights
        shapes = ({n: t.shape for n, t in state.frozen.items()}
                  if tp is None else tp.whole_shapes(state.frozen))
        torch_compat.export_mask_pt(
            os.path.join(args.output_dir, "mask.pt"),
            weight_masks(masker, masks, shapes), masker.specs)
        if args.structured_masking == "heads":
            hm = lang_head_mask(masker, masks, config.l_layers,
                                config.num_attention_heads)
            if hm is not None:
                if is_main_process():
                    np.save(os.path.join(args.output_dir, "head_mask.npy"),
                            hm)
            else:
                common.logger.warning(
                    "structured 'heads' export skipped: no language-layer "
                    "head gates under structured_masking_types=%s",
                    args.structured_masking_types)
        torch_compat.export_classifier_bin(
            os.path.join(args.output_dir, "classifier4masker.bin"),
            state.train_params["classifier"])
        report = masker.sparsity_report(scores, state.thresholds)
        summary["zero_rates"] = report
        common.logger.info("zero rates: %s",
                           {k: round(v, 4) for k, v in report.items()})
        sums = state.opt_state.abs_grad_sum
        if sums is not None:
            # collective when ZeRO or tensor parallelism splits them, then
            # rank 0 writes
            if zero is not None:
                sums = zero.gather_state(state.opt_state).abs_grad_sum
            if tp is not None:
                sums = tp.gather(sums)
            if is_main_process():
                np.savez(os.path.join(args.output_dir, "grad_abs_sum.npz"),
                         **{k: v.cpu().numpy() for k, v in sums.items()})
        return state

    orig_masks = masker.binary_masks(stage2.full_scores(state, tp),
                                     state.thresholds)
    tmp_masks = orig_masks
    best = -1.0
    losses = []
    if args.do_train:
        if args.evaluate_during_training:
            acc0, _ = evaluate(state)
            common.logger.info("pre-train eval acc %.2f (expected LOW right "
                               "after mask patching)", acc0)
        step = state.step
        pending: list = []
        t_last, s_last = time.perf_counter(), step
        guard = common.PreemptionGuard(mesh)
        profiler = common.ProfileWindow(args)
        for epoch in range(int(args.num_train_epochs)):
            for batch in train_batches(epoch):
                if spd > 1:
                    # a partial window goes through single steps at the
                    # epoch's end (the flush below)
                    pending.append(batch)
                    if len(pending) < spd:
                        continue
                    state, wlosses, wscores = multi_fn(
                        state, common.stack_window(pending))
                    pending = []
                    losses.extend(wlosses.unbind(0))
                    metrics = stage2.TrainMetrics(
                        loss=wlosses[-1], score=wscores[-1],
                        batch_size=args.train_batch_size)
                else:
                    state, metrics = step_fn(state, batch)
                    losses.append(metrics.loss)
                prev, step = step, state.step
                profiler.tick(step)
                if common.crossed(step, prev, args.logging_steps):
                    state = reset_fn(state)
                    scores = stage2.full_scores(state, tp)
                    distance = masker.mask_drift(scores, state.thresholds,
                                                 orig_masks)
                    change = masker.mask_drift(scores, state.thresholds,
                                               tmp_masks)
                    tmp_masks = masker.binary_masks(scores, state.thresholds)
                    now = time.perf_counter()
                    ex_s = ((step - s_last) * args.train_batch_size
                            / max(now - t_last, 1e-9))
                    t_last, s_last = now, step
                    common.log_step(step, loss=float(metrics.loss),
                                    score=100 * float(metrics.score)
                                    / metrics.batch_size, epoch=epoch,
                                    mask_distance=distance,
                                    mask_change=change, ex_s=round(ex_s, 1))
                if common.crossed(step, prev, args.save_steps):
                    save(os.path.join(args.output_dir, f"ckpt_{step}"),
                         {"step": step})
                    ckpt.rotate_checkpoints(args.output_dir, keep=2)
                    if args.evaluate_during_training:
                        acc, out = evaluate(state)
                        common.log_step(step, eval_acc=acc)
                        if acc > best:
                            best = acc
                            dump_predictions(
                                os.path.join(args.output_dir, "test.json"),
                                out["logits"], out["question_id"], label2ans)
                            state = export_best(state)
                if guard.save_and_stop(args, step, save):
                    # the batches of an unfinished window are dropped; the
                    # resumed run iterates the epoch again
                    profiler.close()
                    summary.update(step=step, losses=[float(x)
                                                      for x in losses])
                    return summary
            # the epoch's partial window, through single steps
            for leftover in pending:
                state, m = step_fn(state, leftover)
                losses.append(m.loss)
                step = state.step
                profiler.tick(step)
            pending = []
        profiler.close()
        summary["trace"] = profiler.path
        if best < 0:
            # no best-eval export fired: export the final state so the run
            # still yields its artifacts
            state = export_best(state)

    if args.do_eval or args.do_predict:
        acc, out = evaluate(state)
        common.log_step(state.step, final_eval_acc=acc)
        common.write_eval_results(args.output_dir, "eval_results_vqa.txt",
                                  eval_acc=acc)
        if not os.path.exists(os.path.join(args.output_dir, "test.json")):
            dump_predictions(os.path.join(args.output_dir, "test.json"),
                             out["logits"], out["question_id"], label2ans)
    summary.update(step=state.step, losses=[float(x) for x in losses],
                   best_acc=best if best >= 0 else None, state=state)
    return summary


if __name__ == "__main__":
    main()
