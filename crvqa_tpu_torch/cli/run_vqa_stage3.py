"""Stage-3 driver: prune LXMERT to the learned subnetwork for good and
fine-tune it (counterpart of `crvqa_tpu/cli/run_vqa_stage3.py`; same argv
plus `--device`).

    python -m crvqa_tpu_torch.cli.run_vqa_stage3 --output_dir out \\
        --dataroot DATA --img_root FEATS --vocab_file vocab.txt \\
        --stage1_ckpt s1/run_FTlmh_only.bin --mask_pt s2/mask.pt \\
        --classifier_bin s2/classifier4masker.bin --do_train

Loads the stage-1 parameters (`--stage1_ckpt`; seeded init without one),
then one of:

- `FT_trainedMask` (default): the stage-2 `--mask_pt`, applied as constant
  masks over the uniform-rate LXMERT mask table;
- `FT_randMask`: magnitude pruning at `--zero_rate`, over the reference's
  `mag_pruning` scope (`--rand_scope reference`: language layers, pooler,
  word embeddings) or every masked weight at its modality's rate
  (`--rand_scope all`);
- the structured alternative, `--head_mask_npy` ([L, H] 0/1) and / or
  `--ffn_mask_npy` ([L, I] 0/1): the language layers are compacted
  (`masking/compaction.py`) and the model runs with
  `lang_num_heads` / `lang_intermediate_size`.

With a mask it logs the achieved zero rate (`see_weight_rate`) and zeroes
the masked weights; in every case it overlays `--classifier_bin`, then runs
the stage-1 loop with the masks multiplying the weights in every forward.
The parameters go to `<label4save>_FT_trainedMask.bin.msgpack` (or
`<label4save>FT_randMask.bin.msgpack`, the reference's own spelling), the
JAX package's params file and the only file its stage 3 writes, at the
best evaluation or, when none ran, at the end; the port also writes the
torch state_dict under the name without `.msgpack`. `--stage1_ckpt` takes
either kind of file, `--dataset vqavs` the VQA-VS files; `--resume_from`
takes this port's `ckpt_<step>` or the JAX CLI's msgpack one (its masks
too, `common.resume_any`). Metrics, TensorBoard,
wandb and `--profile_dir` as stage 1 (the shared loop).

Not yet ported (raise when set away from their defaults): `--mesh_*`,
`--multihost`.
`--model_type` other than lxmert raises too: the JAX CLI parses it and
never reads it, building LXMERT whatever it says
(`common.reject_model_type`).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core import torch_compat
from ..device import resolve_device
from ..masking import compaction
from ..masking.masker import magnitude_masks, reference_rand_masks
from . import common
from .run_vqa_stage1 import UNPORTED, lxmert_config, train_and_evaluate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_vqa_stage3")
    common.add_common_args(p)
    p.add_argument("--model_type", type=str, default="lxmert",
                   help=common.MODEL_TYPE_HELP)
    p.add_argument("--FT_type", type=str, default="normal",
                   choices=["normal", "lmh", "lpf", "rubi"])
    p.add_argument("--training_type", type=str, default="FT_trainedMask",
                   choices=["FT_trainedMask", "FT_randMask"])
    p.add_argument("--stage1_ckpt", type=str, default=None,
                   help="stage-1 parameters: torch .bin/.pt/.pth or a "
                        "msgpack params file")
    p.add_argument("--mask_pt", type=str, default=None,
                   help="stage-2 mask.pt (required for FT_trainedMask)")
    p.add_argument("--classifier_bin", type=str, default=None,
                   help="stage-2 classifier4masker.bin")
    p.add_argument("--zero_rate", type=float, default=0.7)
    p.add_argument("--rand_scope", type=str, default="reference",
                   choices=["reference", "all"],
                   help="FT_randMask scope: 'reference' = the reference's "
                        "mag_pruning module list (language layers, pooler, "
                        "word embeddings; run_vqa_stage3.py:209-226); 'all' "
                        "= every masked weight at the modal rates")
    p.add_argument("--head_mask_npy", type=str, default=None,
                   help="[L, H] 0/1 head mask .npy -> physical head pruning")
    p.add_argument("--ffn_mask_npy", type=str, default=None,
                   help="[L, intermediate] 0/1 FFN mask .npy -> neuron "
                        "pruning")
    common.add_dense_train_flags(p)
    return p


@torch.no_grad()
def see_weight_rate(masker, params: dict[str, torch.Tensor],
                    masks: dict[str, torch.Tensor]) -> float:
    """The achieved zero rate over the masked weights after pruning
    (run_vqa_stage3.py:75-178)."""
    pruned = masker.prune_params(params, masks)
    zeros = total = 0
    for name in masks:
        zeros += int((pruned[name] == 0).sum())
        total += pruned[name].numel()
    return zeros / total


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


def run(args) -> dict:
    """The stage-3 run; returns the stage-1 loop's summary plus the zero
    rate (`zero_rate`, with a mask) and the language branch's head count
    and FFN width."""
    common.reject_model_type(args, "run_vqa_stage3")
    common.reject_unported(args, UNPORTED)
    device = resolve_device(args.device)
    common.setup_logging(args.output_dir)
    common.dump_args(args, args.output_dir)
    config = lxmert_config(args)
    params = common.lxmert_initial_params(config, args.seed,
                                          args.stage1_ckpt)
    params = {k: v.to(device) for k, v in params.items()}

    masks = None
    rate = None
    specs = ()
    if args.head_mask_npy or args.ffn_mask_npy:
        # physical compaction (HF prune_heads / prune_ffns), in place of an
        # unstructured mask
        overrides = {}
        if args.head_mask_npy:
            head_mask = np.load(args.head_mask_npy)
            common.logger.info("head zero rate: %.3f",
                               float((head_mask == 0).mean()))
            params, overrides["lang_num_heads"] = (
                compaction.compact_lang_heads(params, head_mask,
                                              config.head_size))
        if args.ffn_mask_npy:
            ffn_mask = np.load(args.ffn_mask_npy)
            common.logger.info("ffn zero rate: %.3f",
                               float((ffn_mask == 0).mean()))
            params, overrides["lang_intermediate_size"] = (
                compaction.compact_lang_ffns(params, ffn_mask))
        config = lxmert_config(args, **overrides)
    else:
        masker = common.lxmert_uniform_masker(config, args.zero_rate)
        specs = masker.specs
        if args.training_type == "FT_randMask":
            if args.rand_scope == "reference":
                masks = reference_rand_masks(params, masker.specs,
                                             args.zero_rate)
            else:
                masks = magnitude_masks(params, masker.specs,
                                        masker.zerorate_dict)
        else:
            if not args.mask_pt:
                raise ValueError("--mask_pt is required for FT_trainedMask")
            masks = torch_compat.import_mask_pt(args.mask_pt, masker.specs)
        masks = {k: m.to(device) for k, m in masks.items()}
        rate = see_weight_rate(masker, params, masks)
        common.logger.info("achieved zero rate after pruning: %.4f", rate)
        params = masker.prune_params(params, masks)

    # the stage-2 classifier rides along on either path
    if args.classifier_bin:
        params = common.overlay_classifier(params, args.classifier_bin)

    suffix = ("_FT_trainedMask.bin" if args.training_type == "FT_trainedMask"
              else "FT_randMask.bin")  # the reference's own spelling
    bin_path = os.path.join(args.output_dir, args.label4save + suffix)
    summary = train_and_evaluate(args, config, params, masks, device,
                                 bin_path, specs)
    summary.update(zero_rate=rate, lang_num_heads=config.lang_num_heads,
                   lang_intermediate_size=config.lang_intermediate_size)
    return summary


if __name__ == "__main__":
    main()
