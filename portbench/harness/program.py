"""The system under test: the port's stage-2 state and the calls a cell's
window drives (`crvqa_tpu_torch.train.stage2`), built as
`crvqa_tpu_torch/cli/prune_debias_vqa.py` builds them, from a
configuration's sizes and a traffic mix's settings. Nothing here computes
what is judged: it only calls the program and reads its outputs."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Stage2Program:
    model: torch.nn.Module
    masker: object
    config: object  # stage2.Stage2Config
    state: object   # stage2.Stage2State
    tx: object      # train.common.HfAdamW
    classifier_key: str

    def trainable(self) -> dict[str, torch.Tensor]:
        """The optimizer's leaves keyed by parameter name: the classifier's
        `<key>.<leaf>`, a score by its masked weight's name."""
        from crvqa_tpu_torch.masking.masker import weight_name
        from crvqa_tpu_torch.train import stage2

        by_key = {s.key: weight_name(s) for s in self.masker.specs}
        out = {}
        for k, v in stage2.trainable(self.state, self.config).items():
            kind, rest = k.split("/", 1)
            if kind == "scores":
                out[by_key[rest]] = v
            else:
                out[f"{self.classifier_key}.{rest.split('/', 1)[1]}"] = v
        return out

    def first_moments(self) -> dict[str, torch.Tensor]:
        """The optimizer's first moments, keyed as `trainable`."""
        from crvqa_tpu_torch.train import stage2

        flat = stage2.trainable(self.state, self.config)
        names = dict(zip(flat, self.trainable()))
        return {names[k]: v for k, v in self.state.opt_state.mu.items()}

    def thresholds(self) -> dict[str, torch.Tensor]:
        from crvqa_tpu_torch.masking.masker import weight_name

        return {weight_name(s): self.state.thresholds[s.key]
                for s in self.masker.specs}


def build_stage2(family, cfg: dict, trf: dict, params: dict, seed: int,
                 device) -> Stage2Program:
    """The port's stage-2 state from `params` (every parameter, float32 on
    the device) as the stage-2 CLI builds it: masked weights kept in
    float32, the rest in the compute dtype, magnitude scores, the LMH
    loss's parameters, HfAdamW."""
    from crvqa_tpu_torch.train import stage2

    opt = trf["optimizer"]
    dtype = getattr(torch, cfg["dtype"])
    config = stage2.Stage2Config(
        masker_type=trf["loss"], learning_rate=opt["learning_rate"],
        warmup_steps=0, total_steps=opt["total_steps"], weight_decay=0.0,
        max_grad_norm=opt["max_grad_norm"], adam_epsilon=opt["adam_epsilon"],
        hidden_size=cfg["hidden_size"], classifier_key=family.CLASSIFIER_KEY,
        backbone_dtype="float32", moment_dtype="float32")
    model = family.meta_model(cfg, dtype)
    masker = family.masker(cfg)
    state, tx = stage2.init_state(model, masker, params, config, seed,
                                  device)
    return Stage2Program(model, masker, config, state, tx,
                         family.CLASSIFIER_KEY)
