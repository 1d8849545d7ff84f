"""mPLUG trainer: full-model or mask training of the generative VQA model,
then beam or rank evaluation (counterpart of `crvqa_tpu/cli/vqa_mplug.py`;
the reference's `mPLUG/vqa_mplug.py` main :311-459). Same argv as the JAX
CLI, plus `--device`.

`--do_train` runs the train loop on `--train_files` (or `--synthetic N`
examples of `--synthetic_shapes`): in `--mode mask` (default) the mask
scores and the LM head train and every `--masker_update_step` steps the
thresholds are reset to the MaskerScheduler's target at the fractional
epoch; `--mode full` trains every parameter; `--distill true` adds the
momentum twins' soft labels. It logs `ex_s` every `--logging_steps`,
writes `ckpt_<step>` every `--save_steps` (`--resume_from` restarts from
one, or from the JAX CLI's `ckpt_<step>`: `common.resume_any`, the
`--opt` states by `core/convert.MPLUG_OPT_LAYOUTS`), and ends with a final reset, `mask.pt`, `mask_config.json` and
`ckpt_final`. `--do_eval` / `--do_predict` answer `--test_files` by beam
search or by ranking `--answer_list` into `vqa_result.json`, fetching each
batch's result `--eval_pipeline_depth` batches late. `serve_mplug --ckpt`
serves what it wrote. Step metrics go to `metrics.jsonl` (and
`--tensorboard_dir`, `--wandb_project`); `--profile_dir` traces a step
window (`common.ProfileWindow`); `serve_mplug` accepts these flags and,
like the JAX server, ignores them.

Weights are seeded from `--seed`, then `--init_ckpt` lays a checkpoint
over them before the masker's scores are formed: a reference torch
`.pth`/`.pt`/`.bin` (`torch_compat.load_mplug_torch_checkpoint`; the
pos-embed resize and the `fusion.`/`bert.` shim under
`--init_ckpt_format pretrain`, or `auto` in a full-mode training run; its
`_m` twins override the distill copy) or a msgpack params file of the JAX
package's. `--augment true` (the default) runs the train transforms on
image files. `--opt` takes every name of the reference's factory
(`train/optim.py`, `train/timm_optim.py`); under adahessian the model takes
the plain attention everywhere, as the JAX CLI does, because the attention
kernels have no double backward. `--use_checkpoint` recomputes the ViT's,
the encoders' and the decoder's layers in the backward. Runs on `--device
cuda` (default; raises without a card) or `--device cpu` (the kernels'
plain versions: the tests' path). `serve_mplug` shares the argv, the
model, the masker and the rank function.

`--multihost true` runs one process per device (`parallel/`): the
`--mesh_data` ranks train and answer on their blocks of every global
batch, the gradients averaged over them; the optimizer state is always
sharded over them by whole leaves (`parallel/zero.py`, as the JAX CLI
always shards it), checkpoints are gathered and rank 0 writes.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import torch_compat
from ..device import resolve_device
from ..masking.masker import Masker
from ..masking.mplug_specs import mplug_mask_specs
from ..masking.sparsity_control import MaskerScheduler, ModalSparsity
from ..models.mplug import (MPlugBertConfig, MPlugConfig, ViTConfig,
                            build_mplug)
from ..parallel.mesh import is_main_process
from ..train import mplug_train
from ..train.optim import is_second_order
from . import common

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vqa_mplug")
    common.add_common_args(p)
    p.set_defaults(weight_decay=None, warmup_steps=None)
    p.add_argument("--mode", type=str, default="mask", choices=["full", "mask"])
    p.add_argument("--zero_rate", type=float, default=0.5)
    p.add_argument("--init_sparsity", type=float, default=None)
    p.add_argument("--final_sparsity_epoch", type=float, default=6)
    p.add_argument("--masker_update_step", type=int, default=100)
    p.add_argument("--threshold", type=float, default=1e-2)
    p.add_argument("--init_scale", type=float, default=2e-2)
    p.add_argument("--controlled_init", type=str, default="magnitude_soft")
    p.add_argument("--mask_biases", type=common.str2bool, default=False)
    p.add_argument("--lr1", type=float, default=3e-5)
    p.add_argument("--lr2", type=float, default=5e-6)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--sched", type=str, default="cosine",
                   choices=["cosine", "tanh", "step"])
    p.add_argument("--decay_rate", type=float, default=0.1)
    p.add_argument("--decay_steps", type=int, default=0)
    p.add_argument("--sched_granularity", type=str, default="epoch",
                   choices=["epoch", "step"])
    p.add_argument("--warmup_epochs", type=int, default=4)
    p.add_argument("--warmup_lr", type=float, default=1e-5)
    p.add_argument("--decay_epochs", type=int, default=1)
    p.add_argument("--opt", type=str, default="adamw")
    p.add_argument("--opt_momentum", type=float, default=0.9)
    p.add_argument("--use_bias_reweight", type=common.str2bool, default=True)
    p.add_argument("--distill", type=common.str2bool, default=False)
    p.add_argument("--image_res", type=int, default=384)
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--max_answer_len", type=int, default=12)
    p.add_argument("--decode_cache", type=common.str2bool, default=True,
                   help="incremental beam decode with self-attention KV "
                        "caches (same answers either way)")
    p.add_argument("--min_length", type=int, default=1)
    p.add_argument("--lm_head_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--train_files", type=str, nargs="*", default=None)
    p.add_argument("--test_files", type=str, nargs="*", default=None)
    p.add_argument("--vqa_root", type=str, default="")
    p.add_argument("--init_ckpt", type=str, default=None,
                   help="params init: a msgpack params file of the JAX "
                        "package's, or a reference torch .pt/.pth/.bin "
                        "(vqa_mplug.py:338-376 import: model/module "
                        "unwrap, pos-embed resize, fusion./bert. shim)")
    p.add_argument("--init_ckpt_format", type=str, default="auto",
                   choices=["auto", "pretrain", "finetuned"],
                   help="'pretrain' applies the pos-embed resize and the "
                        "fusion./bert. shim; 'auto' in a full-mode "
                        "training run only (vqa_mplug.py:346)")
    p.add_argument("--clip_name", type=str, default="ViT-B-16",
                   choices=["ViT-B-16", "ViT-L-14"])
    p.add_argument("--use_checkpoint", type=common.str2bool, default=False,
                   help="activation checkpointing of the transformer "
                        "layers in training")
    p.add_argument("--eval_method", type=str, default="beam",
                   choices=["beam", "rank"])
    p.add_argument("--answer_list", type=str, default=None)
    p.add_argument("--k_test", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--alpha_warm_up", type=common.str2bool, default=True)
    p.add_argument("--mask_classifier", type=common.str2bool, default=False)
    p.add_argument("--add_ocr", type=common.str2bool, default=False)
    p.add_argument("--max_input_length", type=int, default=50)
    p.add_argument("--add_object", type=common.str2bool, default=False)
    p.add_argument("--device_normalize", type=common.str2bool, default=True,
                   help="ship uint8 images and CLIP-normalise on the device")
    p.add_argument("--synthetic_shapes", type=str, default="6,5,3")
    p.add_argument("--eval_pipeline_depth", type=int, default=2)
    p.add_argument("--data_workers", type=int, default=4)
    p.add_argument("--augment", type=common.str2bool, default=True)
    return p


def build_model(args) -> tuple[MPlugConfig, Optional[object], torch.nn.Module]:
    """(config, tokenizer or None, the model on the meta device). The
    decode's bos / eos / pad ids are synced from the vocab file
    (vqa_mplug.py:209-222 of the JAX package)."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    lm_head = torch.bfloat16 if args.lm_head_dtype == "bfloat16" else None
    kernels = not is_second_order(args.opt)
    if not kernels:
        common.logger.warning(
            "opt=adahessian needs second-order autodiff: forcing the plain "
            "attention path (the attention kernels have no double "
            "backward; the JAX CLI forces its XLA attention path here, "
            "--fused_attention/--midseq_attention ignored)")
    shared = dict(dtype=dtype, use_checkpoint=args.use_checkpoint,
                  attention_kernels=kernels)
    bert = (MPlugBertConfig.tiny if args.tiny else MPlugBertConfig)(
        lm_head_dtype=lm_head, **shared)
    if args.tiny:
        vit = ViTConfig.tiny(**shared)
    elif args.clip_name == "ViT-L-14":
        vit = ViTConfig.vit_l_14(image_res=args.image_res, **shared)
    else:
        vit = ViTConfig(image_res=args.image_res, **shared)
    config = MPlugConfig(bert=bert, vit=vit, distill=args.distill)
    over = common.config_overrides(args)
    if over.pop("classifier_dropout", None) is not None:
        raise SystemExit("--classifier_dropout has no mPLUG analogue "
                         "(LM-decoder head); remove the flag")
    if over:
        config = dataclasses.replace(
            config, bert=dataclasses.replace(config.bert, **over))
        if "attention_probs_dropout_prob" in over:
            config = dataclasses.replace(config, vit=dataclasses.replace(
                config.vit, attn_dropout=over["attention_probs_dropout_prob"]))
    tokenizer = None
    if not args.synthetic and args.vocab_file:
        from ..data.vqacp import make_tokenizer

        tokenizer = make_tokenizer(args.vocab_file)
        config = dataclasses.replace(
            config, bos_token_id=int(tokenizer.cls_token_id),
            eos_token_id=int(tokenizer.sep_token_id),
            pad_token_id=int(tokenizer.pad_token_id))
    return config, tokenizer, mplug_train.mplug_meta_model(config)


def build_masker(args, config: MPlugConfig) -> Masker:
    """The mPLUG masker (`init_masker`, mPLUG/vqa_mplug.py:59-128). The
    twins live in the state under the SAME names, so the masker needs no
    `_m` specs (they exist only at export time)."""
    c = config.bert
    specs = mplug_mask_specs(
        vit_layers=config.vit.layers,
        text_encoder_layers=c.text_encoder_layers,
        fusion_layers=c.fusion_layers, decoder_layers=c.text_decode_layers,
        stride_layer=c.stride_layer, mask_classifier=args.mask_classifier)
    return Masker.create(specs, ModalSparsity.uniform(args.zero_rate),
                         mask_biases=args.mask_biases,
                         threshold=args.threshold,
                         init_scale=args.init_scale,
                         controlled_init=args.controlled_init)


def build_scheduler(args) -> MaskerScheduler:
    """The target-sparsity schedule the train loop polls: from
    `--init_sparsity` (default: the zero rate, i.e. pinned) to `--zero_rate`
    at `--final_sparsity_epoch`."""
    return MaskerScheduler(
        final_sparsity=args.zero_rate, num_epochs=args.num_train_epochs,
        init_sparsity=args.init_sparsity, lambdas_lr=1.0,
        final_epoch=args.final_sparsity_epoch)


def initial_params(args, config: MPlugConfig) -> dict[str, torch.Tensor]:
    """Seeded fp32 weights from `--seed`, as a state_dict on the CPU."""
    fp32 = dataclasses.replace(
        config, bert=dataclasses.replace(config.bert, dtype=torch.float32),
        vit=dataclasses.replace(config.vit, dtype=torch.float32))
    return build_mplug(fp32, "cpu",
                       torch.Generator().manual_seed(args.seed)).state_dict()


def load_init_ckpt(args, params: dict[str, torch.Tensor]
                   ) -> tuple[dict[str, torch.Tensor],
                              Optional[dict[str, torch.Tensor]]]:
    """`--init_ckpt` over the seeded fp32 `params` (vqa_mplug.py:397-421
    of the JAX package): (params, the checkpoint's `_m` twins or None).
    A torch file goes through the mPLUG importer, its pretrain shims on
    under `--init_ckpt_format pretrain` or, with `auto`, in a full-mode
    training run (the reference's gate, vqa_mplug.py:346); the twins fill
    a copy of the seeded params (only with `--distill`). Anything else is
    a msgpack params file of the JAX package's. Logs the JAX CLI's line:
    missing leaves, unused keys, shims applied."""
    pretrain = (args.init_ckpt_format == "pretrain"
                or (args.init_ckpt_format == "auto" and args.mode == "full"
                    and args.do_train))
    twins = []

    def torch_loader(path, template):
        loaded, loaded_m, report = torch_compat.load_mplug_torch_checkpoint(
            path, template, template_m=template if args.distill else None,
            pretrain_format=pretrain)
        twins.append(loaded_m)
        common.logger.info(
            "init_ckpt %s: %d template leaves missing, %d checkpoint keys "
            "unused%s", path, len(report["missing"]), len(report["unused"]),
            " (pretrain-format shims applied)" if pretrain else "")
        return loaded

    from ..core.convert import mplug_state_dict_from_jax

    params = common.load_params_any(args.init_ckpt, params,
                                    torch_loader=torch_loader,
                                    from_jax=mplug_state_dict_from_jax)
    return params, (twins[0] if twins else None)


def train_config(args, steps_per_epoch: int) -> mplug_train.MPlugTrainConfig:
    """The flags as an `MPlugTrainConfig` (vqa_mplug.py:423-447 of the JAX
    package): mPLUG's own defaults where a flag was not given (weight decay
    0.02, one epoch of warm-up), epoch-granular schedules unless
    `--warmup_steps` opts into the step-granular ones."""
    return mplug_train.MPlugTrainConfig(
        mode=args.mode, lr1=args.lr1, lr2=args.lr2,
        weight_decay=(0.02 if args.weight_decay is None
                      else args.weight_decay),
        warmup_steps=(steps_per_epoch if args.warmup_steps is None
                      else args.warmup_steps),
        total_steps=int(steps_per_epoch * args.num_train_epochs),
        min_lr=args.min_lr, sched=args.sched, decay_rate=args.decay_rate,
        decay_steps=args.decay_steps,
        steps_per_epoch=(steps_per_epoch
                         if args.sched_granularity == "epoch"
                         and args.warmup_steps is None else 0),
        epochs=int(args.num_train_epochs),
        warmup_epochs=args.warmup_epochs, warmup_lr_init=args.warmup_lr,
        decay_epochs=args.decay_epochs, opt=args.opt,
        opt_momentum=args.opt_momentum, max_grad_norm=args.max_grad_norm,
        use_bias_reweight=args.use_bias_reweight, distill=args.distill,
        alpha=args.alpha,
        alpha_warmup_steps=steps_per_epoch if args.alpha_warm_up else 0)


def build_data(args, config: MPlugConfig, tokenizer, device: torch.device,
               mesh=None):
    """(train_batches(epoch), eval_batches(), n_train): `--synthetic N`
    examples of `--synthetic_shapes`, else the annotation files. Batches
    arrive as device tensors through the prefetcher; "qid" and "valid" stay
    numpy. Batch sizes are global: under a data-parallel `mesh` each rank
    keeps its block of every batch."""
    from ..data.mplug_data import (iterate_batches, load_entries,
                                   question_token_len, synthetic_mplug_batch)
    from ..data.prefetch import prefetch_batches

    def staged(batches: Iterator[dict]) -> Iterator[dict]:
        return prefetch_batches(common.local_batches(batches, mesh), device,
                                args.prefetch_batches)

    res = config.vit.image_res
    if args.synthetic:
        ql, al, apq = (int(x) for x in args.synthetic_shapes.split(","))

        def make(bs: int, seed: int) -> dict:
            return synthetic_mplug_batch(
                batch_size=bs, image_res=res, q_len=ql, a_len=al,
                answers_per_question=apq, uint8_images=args.device_normalize,
                vocab_size=config.bert.vocab_size, seed=seed)

        def train_iter(epoch: int) -> Iterator[dict]:
            bs = args.train_batch_size
            for i in range(max(args.synthetic // bs, 1)):
                yield make(bs, epoch * 1000 + i)

        def eval_iter() -> Iterator[dict]:
            bs = args.eval_batch_size
            for i in range(max(args.synthetic // bs, 1)):
                yield make(bs, 90000 + i)

        return (lambda epoch: staged(train_iter(epoch)),
                lambda: staged(eval_iter()), args.synthetic)

    if tokenizer is None:
        raise ValueError("vqa_mplug on files requires --vocab_file")
    q_len = question_token_len(args.add_ocr, args.max_input_length)
    kw = dict(q_len=q_len, vqa_root=args.vqa_root, add_ocr=args.add_ocr,
              add_object=args.add_object)
    train = (load_entries(args.train_files, tokenizer, **kw)
             if args.train_files else None)
    test = (load_entries(args.test_files, tokenizer, **kw)
            if args.test_files else None)

    def train_batches(epoch: int) -> Iterator[dict]:
        return staged(iterate_batches(
            train, args.train_batch_size, res, shuffle=args.train_shuffle,
            seed=args.seed + epoch, drop_last=True, augment=args.augment,
            workers=args.data_workers, raw_images=args.device_normalize))

    def eval_batches() -> Iterator[dict]:
        return staged(iterate_batches(
            test, args.eval_batch_size, res, workers=args.data_workers,
            raw_images=args.device_normalize))

    return train_batches, eval_batches, (len(train) if train else 0)


def build_rank_fn(args, config: MPlugConfig, tokenizer, model, masker,
                  cfg: mplug_train.MPlugTrainConfig, device):
    """Fixed-candidate answer ranking (`rank_answer`,
    model_vqa_mplug.py:188-245). Returns (rank_fn, answers, best_index):
    rank_fn(state, batch) runs on the device; best_index(out) maps its
    output to each row's winning answer-list index (the shortlist path
    returns re-ranked ids best first, the full path LM losses)."""
    from ..data.mplug_data import _tokenize_fixed

    if args.answer_list:
        with open(args.answer_list) as fh:
            answers = json.load(fh)
        ids_np, mask_np = _tokenize_fixed(tokenizer, answers,
                                          args.max_answer_len, extra_eos=True)
        alist_ids = torch.from_numpy(ids_np).long()
        alist_mask = torch.from_numpy(mask_np)
    else:  # the synthetic path: a tiny made-up list
        answers = [f"ans_{i}" for i in range(8)]
        alist_ids = torch.arange(32).reshape(8, 4) % config.bert.vocab_size
        alist_mask = torch.ones(8, 4)
    alist_ids, alist_mask = alist_ids.to(device), alist_mask.to(device)
    use_topk = 0 < args.k_test < len(answers)
    mask = masker if cfg.mode == "mask" else None

    def rank_fn(state, batch):
        args_ = (batch["images"], batch["question_ids"],
                 batch["question_mask"], alist_ids, alist_mask)
        if use_topk:
            return mplug_train.run_masked(
                model, mask, state,
                lambda m, *a: m.rank_answers_topk(*a, k=args.k_test), *args_)
        return mplug_train.run_masked(
            model, mask, state, lambda m, *a: m.rank_answers(*a), *args_)

    def best_index(out) -> np.ndarray:
        if use_topk:
            return out[0][:, 0].cpu().numpy()
        return out.argmin(dim=1).cpu().numpy()

    return rank_fn, answers, best_index


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


def run(args) -> dict:
    """The run; returns a summary: final step, every step's loss, each
    threshold reset's (step, target, achieved zero rate), the last export's
    zero rates, the number of predictions and the final state
    (`state`)."""
    common.init_distributed(args)
    device = resolve_device(args.device)
    mesh = common.make_run_mesh(args, device)
    common.setup_logging(args.output_dir)
    common.dump_args(args, args.output_dir)
    common.init_metrics(args)

    config, tokenizer, model = build_model(args)
    train_batches, eval_batches, n_train = build_data(args, config,
                                                      tokenizer, device, mesh)
    steps_per_epoch = max(n_train // args.train_batch_size, 1)
    cfg = train_config(args, steps_per_epoch)
    masker = scheduler = None
    if args.mode == "mask":
        masker, scheduler = build_masker(args, config), build_scheduler(args)
        # the mask config beside the run (mPLUG/vqa_mplug.py:506-507)
        if is_main_process():
            with open(os.path.join(args.output_dir, "mask_config.json"),
                      "w") as f:
                json.dump({"zero_rate": args.zero_rate,
                           "threshold": args.threshold,
                           "init_scale": args.init_scale,
                           "controlled_init": args.controlled_init,
                           "masker_update_step": args.masker_update_step},
                          f)
    params, params_m = initial_params(args, config), None
    if args.init_ckpt:
        # before init_state: mask mode's magnitude scores read these fp32
        # weights
        params, params_m = load_init_ckpt(args, params)
    state = mplug_train.init_state(
        model, params, cfg, device, masker=masker, seed=args.seed,
        train=args.do_train)
    if params_m is not None and state.params_m is not None:
        # the checkpoint's twins override init_state's copy (the reference
        # copies, then load_state_dict fills the twins, :338-373)
        with torch.no_grad():
            for k, t in params_m.items():
                state.params_m[k].copy_(t)
    if args.resume_from:
        # before the optimizer state is sharded: the file holds all of it
        common.resume_any(args.resume_from, state, "mplug", cfg,
                          masker.specs if masker is not None else None)
    zero = None
    if state.opt_state is not None:
        # ZeRO always, as the JAX CLI shards (vqa_mplug.py:476-480): the
        # identity over one rank
        from ..parallel import ZeroPartition

        zero = ZeroPartition(mplug_train.trainable(state, cfg), mesh)
        state.opt_state = zero.shard_state(state.opt_state)
    gen_fn = mplug_train.make_generate_step(
        model, cfg, masker=masker, beam_size=args.beam_size,
        max_len=args.max_answer_len, min_length=args.min_length,
        use_cache=args.decode_cache)
    summary: dict = {"losses": [], "resets": [], "zero_rates": None,
                     "num_predictions": None, "trace": None}

    if args.do_train:
        step_fn = mplug_train.make_train_step(model, cfg, masker=masker,
                                              mesh=mesh, zero=zero)

        def save(path: str, metadata: dict) -> None:
            ckpt.save_mplug_checkpoint(path, state, metadata, zero=zero)

        reset_fn = (mplug_train.make_threshold_reset(masker)
                    if masker is not None else None)
        losses = []
        step = state.step
        guard = common.PreemptionGuard(mesh)
        profiler = common.ProfileWindow(args)
        t_last, s_last = time.perf_counter(), step
        for epoch in range(int(args.num_train_epochs)):
            for batch_idx, batch in enumerate(train_batches(epoch)):
                state, loss = step_fn(state, batch)
                losses.append(loss)
                prev, step = step, state.step
                profiler.tick(step)
                if masker is not None and common.crossed(
                        step, prev, args.masker_update_step):
                    # the FRACTIONAL epoch: the schedules move at 0.1-epoch
                    # granularity (sparsity_control.py)
                    _, target, _ = scheduler.step(
                        epoch + batch_idx / steps_per_epoch)
                    state = reset_fn(state, float(target))
                    achieved = masker.sparsity_report(
                        state.scores, state.thresholds)["all"]
                    summary["resets"].append((step, float(target), achieved))
                    common.log_step(step, sparsity=achieved, target=target)
                if common.crossed(step, prev, args.logging_steps):
                    loss_f = float(loss)  # device fence
                    now = time.perf_counter()
                    ex_s = ((step - s_last) * args.train_batch_size
                            / max(now - t_last, 1e-9))
                    t_last, s_last = now, step
                    common.log_step(step, loss=loss_f, epoch=epoch,
                                    ex_s=round(ex_s, 1))
                if common.crossed(step, prev, args.save_steps):
                    save(os.path.join(args.output_dir, f"ckpt_{step}"),
                         {"step": step})
                    ckpt.rotate_checkpoints(args.output_dir, keep=2)
                if guard.save_and_stop(args, step, save):
                    profiler.close()
                    summary.update(step=step,
                                   losses=[float(x) for x in losses])
                    return summary
        profiler.close()
        summary["trace"] = profiler.path
        if masker is not None:
            state = reset_fn(state, None)
            masks = masker.binary_masks(state.scores, state.thresholds)
            specs = list(masker.specs)
            if args.distill:
                # mask.pt also carries the twins' masks under `_m` names,
                # binarized from the twins' own EMA'd scores and thresholds
                twins = masker.binary_masks(state.scores_m,
                                            state.thresholds_m)
                live = [s for s in masker.specs if not s.momentum_only]
                for s, twin in zip(live, torch_compat.twin_mask_specs(live)):
                    specs.append(twin)
                    masks[twin.key] = twins[s.key]
            torch_compat.export_mask_pt(
                os.path.join(args.output_dir, "mask.pt"), masks, specs)
            summary["zero_rates"] = masker.sparsity_report(state.scores,
                                                           state.thresholds)
        save(os.path.join(args.output_dir, "ckpt_final"),
             {"step": state.step})
        summary["losses"] = [float(x) for x in losses]

    if args.do_eval or args.do_predict:
        results = evaluate(args, config, tokenizer, model, masker, cfg,
                           state, gen_fn, eval_batches(), device, mesh)
        summary["num_predictions"] = len(results)
    summary.update(step=state.step, state=state)
    return summary


def evaluate(args, config, tokenizer, model, masker, cfg, state, gen_fn,
             batches, device, mesh=None) -> list:
    """Answer every eval batch (beam search, or ranking with
    `--eval_method rank`) into `vqa_result.json`. Each batch's result is
    fetched `--eval_pipeline_depth` batches after it was issued, so the
    device works on the next batches while the host fetches and
    detokenizes (depth 0: the serial loop). Under a data-parallel `mesh`
    each rank answers its block of every batch; the fetch gathers the
    blocks over the data group and the question ids over the control
    group (every rank at the same depth, so the gathers stay aligned),
    and rank 0 writes the file (crvqa_tpu/cli/vqa_mplug.py:576-650)."""
    from ..parallel.mesh import host_all_gather, host_all_gather_local

    rank_fn = answers = best_index = None
    if args.eval_method == "rank":
        rank_fn, answers, best_index = build_rank_fn(
            args, config, tokenizer, model, masker, cfg, device)
    results: list = []
    pending: collections.deque = collections.deque()
    depth = max(args.eval_pipeline_depth, 0)
    t0 = time.perf_counter()

    def flush_one() -> None:
        out, qids, ok_vec = pending.popleft()
        if rank_fn is not None:
            out = (tuple(torch.from_numpy(host_all_gather(t, mesh))
                         for t in out) if isinstance(out, tuple)
                   else torch.from_numpy(host_all_gather(out, mesh)))
            rows = [answers[int(i)] for i in best_index(out)]
        else:
            rows = []
            for row in host_all_gather(out, mesh):
                toks = [int(t) for t in row[1:]]
                if tokenizer is not None:
                    if config.eos_token_id in toks:
                        toks = toks[: toks.index(config.eos_token_id)]
                    rows.append(tokenizer.decode(toks).strip())
                else:
                    rows.append(" ".join(str(t) for t in toks if t != 0))
        for answer, qid, ok in zip(rows, qids, ok_vec):
            if ok:  # not a pad row of a ragged final batch
                results.append({"question_id": int(qid), "answer": answer})

    for batch in batches:
        local_qids = np.asarray(batch["qid"])
        qids = host_all_gather_local(local_qids, mesh)
        ok_vec = host_all_gather_local(np.asarray(batch.get(
            "valid", np.ones(len(local_qids), bool))), mesh)
        out = (rank_fn(state, batch) if rank_fn is not None
               else gen_fn(state, batch)[0])
        pending.append((out, qids, ok_vec))
        while len(pending) > depth:
            flush_one()
    while pending:
        flush_one()
    if is_main_process():
        with open(os.path.join(args.output_dir, "vqa_result.json"),
                  "w") as f:
            json.dump(results, f)
    common.log_step(state.step, num_predictions=len(results),
                    eval_seconds=round(time.perf_counter() - t0, 1),
                    eval_pipeline_depth=depth)
    return results


if __name__ == "__main__":
    main()
