"""Stage-2 driver for VisualBERT: uniform-sparsity mask training
(counterpart of `crvqa_tpu/cli/prune_debias_vqa_visualbert.py`; same argv
plus `--device`).

    python -m crvqa_tpu_torch.cli.prune_debias_vqa_visualbert \\
        --output_dir out --dataroot DATA --img_root FEATS \\
        --vocab_file vocab.txt --train_batch_size 256 --do_train \\
        --evaluate_during_training

Re-design of the reference's `prune_debias_VQA_visualBERT.py` +
`mask_trainer_visualBERT_VQA.py`: single-stream VisualBERT, one zero rate
over K/Q/V/AO/I/O/P/E (no modality split, prune_debias_VQA_visualBERT.py:
127-190), the model called with (input_ids, visual_embeds) only (the box
features of the VQA-CP pipeline, spatials dropped), the classifier head
`model.cls`. Loads `--stage1_ckpt` (a torch .bin/.pt, or the JAX
package's msgpack params file; seeded init without one), trains the mask
scores and the classifier with the `--Masker_type` debias loss, resets
the thresholds every `--logging_steps`, checkpoints and (with
`--evaluate_during_training`) evaluates every `--save_steps`,
and at each new best writes `test.json`, `mask.pt` (VisualBERT's torch
names) and `classifier4masker.bin` (the `cls` head) in the JAX CLI's
formats. Step metrics go to `metrics.jsonl` (and `--tensorboard_dir`,
`--wandb_project`); `--profile_dir` traces a step window
(`common.ProfileWindow`). Runs on the card (`--device cuda`, the default,
raising without one); `--device cpu` runs the kernels' plain versions.

`--resume_from` takes a `ckpt_<step>` of this port or of the JAX CLI
(`common.resume_any`).

Not yet ported (raise when set away from their defaults): `--mesh_*`,
`--multihost`; `--model_type` other than visualbert (the JAX CLI parses it and builds
VisualBERT whatever it says). `--dataset vqavs` reads the VQA-VS files.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..core import checkpoint as ckpt
from ..core import torch_compat
from ..device import resolve_device
from ..models import VisualBertConfig
from ..train import stage2
from ..train.evaluation import dump_predictions, predict, vqa_accuracy
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("prune_debias_vqa_visualbert")
    common.add_common_args(p)
    p.add_argument("--model_type", type=str, default="visualbert",
                   help="visualbert (the JAX CLI parses this flag and "
                        "always builds VisualBERT)")
    common.add_moment_dtype_flag(p)
    p.add_argument("--zero_rate", type=float, default=0.7)
    p.add_argument("--FTmodel_type", type=str, default="noFT")
    p.add_argument("--Masker_type", type=str, default="lmh",
                   choices=["normal", "lmh", "lpf", "rubi", "poe",
                            "reweight"])
    p.add_argument("--stage1_ckpt", type=str, default=None,
                   help="stage-1 checkpoint (torch .bin/.pt state_dict or "
                        "module pickle, or a msgpack params file)")
    p.add_argument("--controlled_init", type=str, default="magnitude")
    p.add_argument("--threshold", type=float, default=1e-2)
    p.add_argument("--init_scale", type=float, default=2e-2)
    p.add_argument("--name_of_masker", type=str, default="MaskedLinear1")
    p.add_argument("--mask_biases", type=common.str2bool, default=False,
                   help="also mask bias vectors (maskers_visualBert "
                        "mask_biases; default False in every shipped config)")
    return p


def _to_visualbert_batch(batch: dict) -> dict:
    """LXMERT-style batches carry (visual_feats, visual_pos); VisualBERT
    consumes the 2048-d features directly as visual_embeds."""
    out = dict(batch)
    if "visual_embeds" not in out and "visual_feats" in out:
        out["visual_embeds"] = out.pop("visual_feats")
        out.pop("visual_pos", None)
    return out


class _DataConfig:
    """The widths the VQA-CP pipeline (`common.build_data`) reads, for a
    VisualBERT config: its features are the visual embeddings."""

    def __init__(self, config: VisualBertConfig):
        self.vocab_size = config.vocab_size
        self.ans_num = config.ans_num
        self.visual_feat_dim = config.visual_embedding_dim
        self.visual_pos_dim = 4


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


def run(args) -> dict:
    """The stage-2 run; returns a summary: final step, every step's loss,
    best eval accuracy, the zero rates of the last export and the final
    state (`state`)."""
    if args.model_type != "visualbert":
        raise NotImplementedError(
            f"--model_type {args.model_type}: prune_debias_vqa_visualbert "
            "trains VisualBERT (LXMERT's stage 2 is prune_debias_vqa)")
    common.reject_unported(args, common.COMMON_UNPORTED)
    device = resolve_device(args.device)
    common.setup_logging(args.output_dir)
    common.dump_args(args, args.output_dir)
    common.init_metrics(args)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    overrides = common.config_overrides(args)
    config = (VisualBertConfig.tiny(dtype=dtype, **overrides) if args.tiny
              else VisualBertConfig(ans_num=args.ans_num, dtype=dtype,
                                    **overrides))
    params = common.visualbert_initial_params(config, args.seed,
                                              args.stage1_ckpt)
    masker = common.visualbert_uniform_masker(
        config, args.zero_rate, mask_biases=args.mask_biases,
        threshold=args.threshold, init_scale=args.init_scale,
        controlled_init=args.controlled_init,
        binarizer_name=args.name_of_masker)

    train_data, eval_data, label2ans, n_train = common.build_data(
        args, _DataConfig(config), device)
    train_batches = lambda epoch: map(_to_visualbert_batch,
                                      train_data(epoch))
    eval_batches = lambda: map(_to_visualbert_batch, eval_data())
    cfg = stage2.Stage2Config(
        masker_type=args.Masker_type, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        total_steps=common.scheduler_horizon(
            n_train, args.train_batch_size, args.num_train_epochs),
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        adam_epsilon=args.adam_epsilon, gamma=args.gamma,
        hidden_size=config.hidden_size, classifier_key="cls",
        backbone_dtype=args.backbone_dtype, moment_dtype=args.moment_dtype)
    model = stage2.visualbert_meta_model(config)
    state, tx = stage2.init_state(model, masker, params, cfg, args.seed,
                                  device)
    del params
    if args.resume_from:
        common.resume_any(args.resume_from, state, "stage2", cfg,
                          masker.specs)
    step_fn = stage2.make_train_step(model, masker, tx, cfg)
    reset_fn = stage2.make_threshold_reset(masker)
    eval_fn = stage2.make_eval_step(model, masker, cfg)
    summary: dict = {"losses": [], "best_acc": None, "zero_rates": None,
                     "trace": None}

    def evaluate(state):
        out = predict(eval_fn, state, eval_batches())
        return vqa_accuracy(out["logits"], out["labels"]), out

    def export_best(state):
        state = reset_fn(state)
        torch_compat.export_mask_pt(
            os.path.join(args.output_dir, "mask.pt"),
            masker.binary_masks(state.scores, state.thresholds),
            masker.specs)
        torch_compat.export_classifier_bin(
            os.path.join(args.output_dir, "classifier4masker.bin"),
            state.train_params["classifier"])
        report = masker.sparsity_report(state.scores, state.thresholds)
        summary["zero_rates"] = report
        common.logger.info("zero rates: %s",
                           {k: round(v, 4) for k, v in report.items()})
        return state

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
                    state = reset_fn(state)
                    now = time.perf_counter()
                    ex_s = ((step - s_last) * args.train_batch_size
                            / max(now - t_last, 1e-9))
                    t_last, s_last = now, step
                    common.log_step(step, loss=float(metrics.loss),
                                    score=100 * float(metrics.score)
                                    / metrics.batch_size, epoch=epoch,
                                    ex_s=round(ex_s, 1))
                if common.crossed(step, prev, args.save_steps):
                    ckpt.save_checkpoint(
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
                            state = export_best(state)
                if guard.triggered:
                    path = os.path.join(args.output_dir, f"ckpt_{step}")
                    ckpt.save_checkpoint(path, state, metadata={
                        "step": step, "preempted": True})
                    common.log_step(step, preempted=True, checkpoint=path)
                    profiler.close()
                    summary.update(step=step, losses=[float(x)
                                                      for x in losses])
                    return summary
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
