"""mPLUG CLI pieces shared with `serve_mplug` (counterpart of
`crvqa_tpu/cli/vqa_mplug.py`): the argv (the JAX CLI's, plus `--device`),
the model, the masker and the rank function. Training (`main`) is not yet
ported: it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..masking.masker import Masker
from ..masking.mplug_specs import mplug_mask_specs
from ..masking.sparsity_control import ModalSparsity
from ..models.mplug import MPlugBertConfig, MPlugConfig, ViTConfig
from ..train import mplug_train
from . import common

# flags of paths this slice does not reach -> their defaults; set elsewhere
# they raise "not yet ported"
MPLUG_UNPORTED = {**common.COMMON_UNPORTED, "init_ckpt": None,
                  "init_ckpt_format": "auto", "resume_from": None,
                  "use_checkpoint": False}


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
                   help="not yet ported (msgpack or reference .pth import)")
    p.add_argument("--init_ckpt_format", type=str, default="auto",
                   choices=["auto", "pretrain", "finetuned"],
                   help="not yet ported")
    p.add_argument("--clip_name", type=str, default="ViT-B-16",
                   choices=["ViT-B-16", "ViT-L-14"])
    p.add_argument("--use_checkpoint", type=common.str2bool, default=False,
                   help="not yet ported (activation checkpointing)")
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
    bert = (MPlugBertConfig.tiny if args.tiny else MPlugBertConfig)(
        dtype=dtype, lm_head_dtype=lm_head)
    if args.tiny:
        vit = ViTConfig.tiny(dtype=dtype)
    elif args.clip_name == "ViT-L-14":
        vit = ViTConfig.vit_l_14(image_res=args.image_res, dtype=dtype)
    else:
        vit = ViTConfig(image_res=args.image_res, dtype=dtype)
    config = MPlugConfig(bert=bert, vit=vit)
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
    """The mPLUG masker (`init_masker`, mPLUG/vqa_mplug.py:59-128); its
    MaskerScheduler waits for the training slice."""
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


def main(argv=None) -> None:
    build_parser().parse_args(argv)
    raise NotImplementedError(
        "mPLUG training (vqa_mplug main) is not yet ported to "
        "crvqa_tpu_torch (ROADMAP): serve with crvqa_tpu_torch.cli."
        "serve_mplug")


if __name__ == "__main__":
    main()
