"""Stage 1 — dense fine-tuning — and stage 3, the same loop on a
permanently pruned model (counterpart of `crvqa_tpu/train/stage1.py`; the
reference's `mask_trainer_VQA.py`, `run_vqa_stage1.py`,
`run_vqa_stage3.py`).

Every parameter trains; `ft_type` selects the debias loss. The model is
built on the meta device and runs through `torch.func.functional_call` on
the state's fp32 parameters, cast per forward to the dtypes the model
computes in (the cast the JAX package applies at every apply). For stage 3
constant masks multiply the masked weights in every forward (the
counterpart of `prune.CustomFromMask`): masked entries get exactly zero
gradient, so Adam never moves them off zero.

The state is updated IN PLACE by the step (the JAX package returns a new
one): the optimizer writes parameters and moments where they are; the
step counter and the generators advance. `make_multi_step` (several steps
in one dispatch) has no counterpart yet: no CLI calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import functional_call

from ..losses import dispatch_loss, learned_mixin_init
from ..models.layers import set_generators
from .common import (Adam, AdamWState, TrainMetrics, TrainRNG,
                     allreduce_grads_, batch_score, hidden_dropout_generator,
                     make_adam, model_inputs, reduce_metrics)
from .stage2 import param_dtypes


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    ft_type: str = "normal"  # normal | lmh | lpf | rubi
    learning_rate: float = 5e-5
    warmup_steps: int = 34235  # bash_files/Stage1/run_vqa_stage1.sh
    total_steps: int = 100_000
    max_grad_norm: float = 1.0
    adam_epsilon: float = 1e-8
    gamma: float = 5.0
    lmh_w: float = 0.36
    hidden_size: int = 768
    # the reference's LearnedMixin lives on the Trainer, outside the
    # optimizer and its clip (`run_vqa_stage1.py:341-362`): its parameters
    # get gradients but are never stepped. True = train them too.
    train_lmh: bool = False
    grad_accum_steps: int = 1
    moment_dtype: str = "float32"  # storage of the Adam moments


@dataclasses.dataclass
class Stage1State:
    step: int
    params: dict[str, torch.Tensor]  # fp32 state_dict, every leaf trained
    lmh_params: Optional[dict[str, torch.Tensor]]
    # stage 3: constant 0/1 masks by weight name, in the weights' dtype
    masks: Optional[dict[str, torch.Tensor]]
    opt_state: AdamWState
    rng: TrainRNG


def trainable(state: Stage1State, config: Stage1Config
              ) -> dict[str, torch.Tensor]:
    """The optimizer's flat view: every parameter, and the LMH parameters
    only with `train_lmh`."""
    out = {f"params/{k}": v for k, v in state.params.items()}
    if config.train_lmh and state.lmh_params is not None:
        out.update({f"lmh/{k}": v for k, v in state.lmh_params.items()})
    return out


def init_state(params: dict[str, torch.Tensor], config: Stage1Config,
               seed: int, device,
               masks: Optional[dict[str, torch.Tensor]] = None
               ) -> tuple[Stage1State, Adam]:
    """The training state from a full fp32 state_dict (`init_state` of the
    JAX package): fresh copies of the parameters on `device`, the LMH
    parameters for the lmh / poe losses, masks (bool or 0/1, by weight
    name) as constants in the weights' dtype, and the optimizer."""
    device = torch.device(device)
    params = {k: v.detach().to(device, torch.float32, copy=True)
              .requires_grad_(True) for k, v in params.items()}
    if masks is not None:
        masks = {k: m.to(device, params[k].dtype) for k, m in masks.items()}
    lmh = None
    if config.ft_type in ("lmh", "poe"):
        lmh = learned_mixin_init(torch.Generator().manual_seed(seed + 3),
                                 config.hidden_size, device=device)
        lmh = {k: v.requires_grad_(config.train_lmh) for k, v in lmh.items()}
    tx = make_adam(config.learning_rate, config.warmup_steps,
                   config.total_steps, config.max_grad_norm,
                   eps=config.adam_epsilon,
                   moment_dtype=(torch.bfloat16
                                 if config.moment_dtype == "bfloat16"
                                 else None))
    state = Stage1State(step=0, params=params, lmh_params=lmh, masks=masks,
                        opt_state=None, rng=TrainRNG.from_seed(seed, device))
    state.opt_state = tx.init(trainable(state, config))
    return state, tx


def model_params(model_dtypes: dict[str, torch.dtype], state: Stage1State
                 ) -> dict[str, torch.Tensor]:
    """The model's parameter dict: each parameter times its mask (stage 3),
    cast to the dtype the model holds it in."""
    out = {}
    for name, p in state.params.items():
        if state.masks is not None and name in state.masks:
            p = p * state.masks[name]
        dt = model_dtypes[name]
        out[name] = p if p.dtype == dt else p.to(dt)
    return out


def make_loss_and_grads(model: torch.nn.Module, config: Stage1Config,
                        mesh=None) -> Callable:
    """fn(state, batch) -> (loss, score, grads keyed as `trainable`): the
    forward in training mode (dropout from the state's generators) and the
    backward, averaged over `grad_accum_steps` microbatches; local to this
    rank's block of the batch under a data-parallel `mesh`."""
    dtypes = param_dtypes(model)

    def microbatch(state, batch):
        leaves = trainable(state, config)
        logits, pooled = functional_call(model, model_params(dtypes, state),
                                         (), model_inputs(batch), strict=True)
        loss = dispatch_loss(
            config.ft_type, logits=logits, pooled=pooled,
            labels=batch["labels"], bias=batch.get("bias"),
            max_label=batch.get("max_label"), lmh_params=state.lmh_params,
            gamma=config.gamma, lmh_w=config.lmh_w)
        # the last cross layer's visual branch never reaches the logits:
        # its parameters get zero gradients, as under jax.grad
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return (loss.detach(), batch_score(logits.detach(), batch["labels"]),
                grads)

    def loss_and_grads(state: Stage1State, batch: dict):
        model.train()
        set_generators(model, hidden_dropout_generator(state.rng, state.step,
                                                       mesh),
                       state.rng.host, mesh.data_index if mesh else 0)
        accum = config.grad_accum_steps
        if accum <= 1:
            return microbatch(state, batch)
        n = batch["labels"].shape[0]
        if n % accum:
            raise ValueError(f"batch {n} not divisible by "
                             f"grad_accum_steps {accum}")
        m = n // accum
        loss_sum = score_sum = grads = None
        for a in range(accum):
            mb = {k: v[a * m:(a + 1) * m] for k, v in batch.items()}
            loss, score, g = microbatch(state, mb)
            if grads is None:
                loss_sum, score_sum, grads = loss, score, g
            else:
                loss_sum, score_sum = loss_sum + loss, score_sum + score
                torch._foreach_add_(list(grads.values()), list(g.values()))
        torch._foreach_div_(list(grads.values()), accum)
        return loss_sum / accum, score_sum, grads

    return loss_and_grads


def make_train_step(model: torch.nn.Module, config: Stage1Config, tx: Adam,
                    mesh=None) -> Callable:
    """fn(state, batch) -> (state, TrainMetrics): one clipped Adam step,
    updating `state` in place. Stage 3 is the same step on a state that
    carries masks. `mesh`: `batch` is this rank's block; the gradients are
    averaged over the data group before Adam clips them."""
    loss_and_grads = make_loss_and_grads(model, config, mesh)

    def train_step(state: Stage1State, batch: dict):
        loss, score, grads = loss_and_grads(state, batch)
        allreduce_grads_(grads, mesh)
        tx.step(trainable(state, config), grads, state.opt_state)
        state.step += 1
        loss, score, size = reduce_metrics(
            loss, score, int(batch["labels"].shape[0]), mesh)
        return state, TrainMetrics(loss=loss, score=score, batch_size=size)

    return train_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """fn(state, batch) -> fp32 logits: the (masked) model in eval mode,
    no dropout."""
    dtypes = param_dtypes(model)

    @torch.inference_mode()
    def eval_step(state: Stage1State, batch: dict) -> torch.Tensor:
        model.eval()
        logits, _ = functional_call(model, model_params(dtypes, state), (),
                                    model_inputs(batch), strict=True)
        return logits

    return eval_step
