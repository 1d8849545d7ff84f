"""mPLUG in the program (`crvqa_tpu_torch`), built as
`crvqa_tpu_torch/cli/vqa_mplug.py` builds it: the CLI's own parser,
`build_model`, `build_masker`, `build_scheduler` and `train_config` on
the flags a configuration file and a traffic mix state, the sizes then
laid over the model's config (a no-op at the published widths; the
tests' tiny presets cut them). The training state, mesh and ZeRO
partition are the CLI's too. The benchmark's plain reference beside it."""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference import mplug as reference

_VIT = {"image_res": "image_res", "patch_size": "patch_size",
        "width": "vision_width", "layers": "vision_layers",
        "heads": "vision_heads", "attn_dropout": "attn_dropout"}
_BERT = ("vocab_size", "hidden_size", "num_attention_heads",
         "intermediate_size", "text_encoder_layers", "fusion_layers",
         "text_decode_layers", "stride_layer", "hidden_dropout_prob",
         "attention_probs_dropout_prob", "max_position_embeddings",
         "type_vocab_size", "layer_norm_eps")


@dataclasses.dataclass
class MPlugProgram:
    model: torch.nn.Module
    masker: object
    scheduler: object   # masking.sparsity_control.MaskerScheduler
    config: object      # train.mplug_train.MPlugTrainConfig
    state: object       # train.mplug_train.MPlugState
    mesh: object
    zero: object
    steps_per_epoch: int

    def trainable(self) -> dict[str, torch.Tensor]:
        """The optimizer's leaves keyed by parameter name: a score by its
        masked weight's name, a head tensor by its own."""
        from crvqa_tpu_torch.masking.masker import weight_name
        from crvqa_tpu_torch.train import mplug_train

        by_key = {s.key: weight_name(s) for s in self.masker.specs}
        out = {}
        for k, v in mplug_train.trainable(self.state, self.config).items():
            kind, rest = k.split("/", 1)
            out[by_key[rest] if kind == "scores" else rest] = v
        return out

    def first_moments(self) -> dict[str, torch.Tensor]:
        """The optimizer's first moments, keyed as `trainable`."""
        from crvqa_tpu_torch.train import mplug_train

        flat = mplug_train.trainable(self.state, self.config)
        names = dict(zip(flat, self.trainable()))
        return {names[k]: v for k, v in self.state.opt_state.mu.items()}

    def thresholds(self) -> dict[str, torch.Tensor]:
        from crvqa_tpu_torch.masking.masker import weight_name

        return {weight_name(s): self.state.thresholds[s.key]
                for s in self.masker.specs}


def cli_args(cfg: dict, trf: dict, seed: int, device):
    """The `vqa_mplug` argv of this configuration and traffic (the
    traffic's optimizer settings are the CLI's defaults), parsed by the
    CLI's own parser, every other flag at its default."""
    from crvqa_tpu_torch.cli import vqa_mplug

    m, opt = cfg["masker"], trf["optimizer"]
    sched = opt["sched"]
    argv = ["--output_dir", "unused", "--device", torch.device(device).type,
            "--dtype", cfg["dtype"], "--image_res", str(cfg["image_res"]),
            "--seed", str(seed), "--mode", "mask",
            "--train_batch_size", str(trf["batch_size"]),
            "--zero_rate", str(m["zero_rate"]),
            "--threshold", str(m["threshold"]),
            "--controlled_init", m["controlled_init"],
            "--masker_update_step", str(trf["masker_update_step"]),
            "--logging_steps", str(trf["logging_steps"]),
            "--opt", opt["name"], "--lr1", str(opt["lr1"]),
            "--lr2", str(opt["lr2"]),
            "--weight_decay", str(opt["weight_decay"]),
            "--max_grad_norm", str(opt["max_grad_norm"]),
            "--sched", sched["name"],
            "--warmup_epochs", str(sched["warmup_epochs"]),
            "--warmup_lr", str(sched["warmup_lr"]),
            "--num_train_epochs", str(sched["epochs"]),
            "--min_lr", str(sched["min_lr"])]
    return vqa_mplug.build_parser().parse_args(argv)


def build(cfg: dict, trf: dict, params: dict, seed: int,
          device) -> MPlugProgram:
    """The CLI's training state from `params` (every parameter, float32 on
    the device): magnitude_soft scores from them, the trained leaves in
    float32, the rest cast to the compute dtype, the two-group AdamW
    sharded by the (one-rank) ZeRO partition."""
    from crvqa_tpu_torch.cli import common, vqa_mplug
    from crvqa_tpu_torch.parallel import ZeroPartition
    from crvqa_tpu_torch.train import mplug_train

    args = cli_args(cfg, trf, seed, device)
    config, _, _ = vqa_mplug.build_model(args)
    config = dataclasses.replace(
        config,
        vit=dataclasses.replace(config.vit, **{k: cfg[v]
                                               for k, v in _VIT.items()}),
        bert=dataclasses.replace(config.bert, **{k: cfg[k] for k in _BERT}))
    model = mplug_train.mplug_meta_model(config)
    masker = vqa_mplug.build_masker(args, config)
    scheduler = vqa_mplug.build_scheduler(args)
    steps_per_epoch = optimizer_settings(trf)["sched"]["steps_per_epoch"]
    tcfg = vqa_mplug.train_config(args, steps_per_epoch)
    device = torch.device(device)
    mesh = common.make_run_mesh(args, device)
    state = mplug_train.init_state(model, params, tcfg, device, masker=masker,
                                   seed=seed, train=True)
    zero = ZeroPartition(mplug_train.trainable(state, tcfg), mesh)
    state.opt_state = zero.shard_state(state.opt_state)
    return MPlugProgram(model, masker, scheduler, tcfg, state, mesh, zero,
                        steps_per_epoch)


def optimizer_settings(trf: dict) -> dict:
    """The traffic's optimizer settings with the schedule's steps an
    epoch: the training split's questions over the batch."""
    opt = dict(trf["optimizer"])
    opt["sched"] = dict(opt["sched"], steps_per_epoch=max(
        trf["train_questions"] // trf["batch_size"], 1))
    return opt


def check_settings(prog: MPlugProgram, opt: dict) -> None:
    """Raise unless the CLI's optimizer settings are `opt`
    (`optimizer_settings`), which the reference takes: a changed default
    shows here, not as a gap."""
    c = prog.config
    got = {"name": c.opt, "lr1": c.lr1, "lr2": c.lr2,
           "weight_decay": c.weight_decay, "max_grad_norm": c.max_grad_norm,
           "sched": {"name": c.sched, "steps_per_epoch": c.steps_per_epoch,
                     "warmup_epochs": c.warmup_epochs,
                     "warmup_lr": c.warmup_lr_init, "epochs": c.epochs,
                     "min_lr": c.min_lr},
           "use_bias_reweight": c.use_bias_reweight, "distill": c.distill}
    if got != opt:
        raise ValueError(f"the CLI's optimizer settings {got} are not the "
                         f"traffic's {opt}")
