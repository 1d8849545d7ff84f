"""Stage 2 — mask training, the hot path (counterpart of
`crvqa_tpu/train/stage2.py`; the reference's `mask_trainer_Robust_VQA.py`
and `prune_debias_VQA.py`).

The model is built on the meta device and never holds weights: every
forward runs `torch.func.functional_call` on a parameter dict of the
frozen backbone with each masked weight replaced by `w * binarize(s, t)`
(`Masker.apply_masks`) and the trainable classifier. Trainable leaves are
the mask scores, the classifier and (only with `train_lmh`) the
LearnedMixin parameters. Thresholds are reset to each module's k-th score
every `logging_steps` by the driver.

The state is updated IN PLACE by the step (the JAX package returns a new
state): the optimizer writes scores, classifier and moments where they
are, and the step counter and generators advance.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import functional_call

from ..losses import dispatch_loss, learned_mixin_init
from ..masking.binarizers import clamp_scores_sign_
from ..masking.masker import Masker, bias_key, weight_name
from ..models.layers import set_generators
from .common import (HfAdamW, HfAdamWState, TrainMetrics, TrainRNG,
                     allreduce_grads_, batch_score, clip_by_global_norm_,
                     hidden_dropout_generator, linear_warmup_schedule,
                     model_inputs, reduce_metrics)


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    masker_type: str = "lmh"  # normal | lmh | lpf | rubi | poe | reweight
    learning_rate: float = 5e-5
    warmup_steps: int = 0
    total_steps: int = 100_000
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    adam_epsilon: float = 1e-8
    gamma: float = 5.0  # LPF focal exponent
    lmh_w: float = 0.36
    hidden_size: int = 768
    # the reference never steps LearnedMixin's bias_lin / smooth_param (they
    # live on the Trainer, outside the optimizer and its clip,
    # mask_trainer_Robust_VQA.py:248 vs prune_debias_VQA.py:612-630)
    train_lmh: bool = False
    grad_accum_steps: int = 1
    accumulate_abs_grad: bool = False
    backbone_dtype: str = "float32"  # storage of the masked frozen weights
    moment_dtype: str = "float32"    # storage of the Adam moments
    # the head's name in the model; the state keeps it under
    # train_params["classifier"] whatever the model calls it
    classifier_key: str = "classifier"  # "cls" for VisualBERT


Stage2RNG = TrainRNG  # device + host generators (train/common.py)


@dataclasses.dataclass
class Stage2State:
    step: int
    frozen: dict[str, torch.Tensor]  # backbone (no classifier) by name
    train_params: dict[str, dict[str, torch.Tensor]]  # classifier, lmh
    scores: dict[str, torch.Tensor]  # spec.key -> [out, in] fp32
    thresholds: dict[str, torch.Tensor]  # spec.key -> 0-d fp32
    opt_state: HfAdamWState
    rng: Stage2RNG


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def param_dtypes(model: torch.nn.Module) -> dict[str, torch.dtype]:
    """The dtype each parameter has in the model (Linear weights and biases
    in the compute dtype, embeddings / LayerNorms / classifier fp32)."""
    return {n: p.dtype for n, p in model.named_parameters()}


def trainable(state: Stage2State, config: Stage2Config
              ) -> dict[str, torch.Tensor]:
    """The optimizer's flat view of what it steps: classifier, LMH (only
    with train_lmh) and scores."""
    out = {f"train/classifier/{k}": v
           for k, v in state.train_params["classifier"].items()}
    if config.train_lmh and "lmh" in state.train_params:
        out.update({f"train/lmh/{k}": v
                    for k, v in state.train_params["lmh"].items()})
    out.update({f"scores/{k}": v for k, v in state.scores.items()})
    return out


def init_state(model: torch.nn.Module, masker: Masker,
               params: dict[str, torch.Tensor], config: Stage2Config,
               seed: int, device) -> tuple[Stage2State, HfAdamW]:
    """Freeze the backbone, build scores by the controlled init, split the
    trainables (`init_state` of the JAX package). `params` is a full fp32
    state_dict (the classifier included, under `config.classifier_key`). Masked weights (and masked biases)
    are stored in `backbone_dtype`; every other frozen parameter directly
    in the dtype the model computes with (the cast the JAX package applies
    at every apply)."""
    device = torch.device(device)
    params = {k: v.to(device) for k, v in params.items()}
    rng = Stage2RNG.from_seed(seed, device)
    init_gen = torch.Generator().manual_seed(seed + 2)
    scores, thresholds = masker.init(params, init_gen)
    for s in scores.values():
        s.requires_grad_(True)
    dtypes = param_dtypes(model)
    masked = {weight_name(s) for s in masker.specs}
    if masker.mask_biases:
        masked |= {f"{s.torch_name}.bias" for s in masker.specs
                   if bias_key(s) in scores}
    backbone = _dtype(config.backbone_dtype)
    prefix = config.classifier_key + "."
    frozen = {}
    for name, t in params.items():
        if name.startswith(prefix):
            continue
        dt = backbone if name in masked else dtypes[name]
        frozen[name] = t.to(dt) if t.dtype.is_floating_point else t
    train_params = {"classifier": {
        k[len(prefix):]: v.detach().clone().float().requires_grad_(True)
        for k, v in params.items() if k.startswith(prefix)}}
    if config.masker_type in ("lmh", "poe"):
        lmh = learned_mixin_init(torch.Generator().manual_seed(seed + 3),
                                 config.hidden_size, device=device)
        train_params["lmh"] = {k: v.requires_grad_(config.train_lmh)
                               for k, v in lmh.items()}
    tx = HfAdamW(linear_warmup_schedule(config.learning_rate,
                                        config.warmup_steps,
                                        config.total_steps),
                 eps=config.adam_epsilon, weight_decay=config.weight_decay,
                 accumulate_abs_grad=config.accumulate_abs_grad,
                 moment_dtype=(torch.bfloat16
                               if config.moment_dtype == "bfloat16" else None))
    state = Stage2State(step=0, frozen=frozen, train_params=train_params,
                        scores=scores, thresholds=thresholds,
                        opt_state=None, rng=rng)
    state.opt_state = tx.init(trainable(state, config))
    return state, tx


def masked_params(model_dtypes: dict[str, torch.dtype], masker: Masker,
                  state: Stage2State, generator=None,
                  classifier_key: str = "classifier"
                  ) -> dict[str, torch.Tensor]:
    """The model's full parameter dict: frozen backbone with the masks
    applied (cast to the model's dtypes) plus the trainable classifier
    under `classifier_key`."""
    masked = masker.apply_masks(state.frozen, state.scores, state.thresholds,
                                generator=generator)
    out = {n: (t if t.dtype == model_dtypes[n] else t.to(model_dtypes[n]))
           for n, t in masked.items()}
    out.update({f"{classifier_key}.{k}": v
                for k, v in state.train_params["classifier"].items()})
    return out


def make_loss_and_grads(model: torch.nn.Module, masker: Masker,
                        config: Stage2Config, mesh=None) -> Callable:
    """fn(state, batch) -> (loss, score, grads keyed as `trainable`): the
    forward on the masked model in training mode (dropout on, from the
    state's generators) and the backward, averaged over
    `grad_accum_steps` microbatches (`_training_step`,
    mask_trainer_Robust_VQA.py:656-676, 801-886). With a data-parallel
    `mesh` the batch is this rank's block and everything is local: the
    caller reduces over the data group."""
    dtypes = param_dtypes(model)

    def microbatch(state, batch):
        leaves = trainable(state, config)
        params = masked_params(dtypes, masker, state, state.rng.device,
                               config.classifier_key)
        logits, pooled = functional_call(model, params, (),
                                         model_inputs(batch), strict=True)
        loss = dispatch_loss(
            config.masker_type, logits=logits, pooled=pooled,
            labels=batch["labels"], bias=batch.get("bias"),
            max_label=batch.get("max_label"),
            lmh_params=state.train_params.get("lmh"),
            gamma=config.gamma, lmh_w=config.lmh_w)
        # the last cross layer's visual branch never reaches the logits:
        # its scores get zero gradients, as under jax.grad
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return (loss.detach(), batch_score(logits.detach(), batch["labels"]),
                grads)

    def loss_and_grads(state: Stage2State, batch: dict):
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


def make_train_step(model: torch.nn.Module, masker: Masker, tx: HfAdamW,
                    config: Stage2Config, mesh=None, tp=None) -> Callable:
    """fn(state, batch) -> (state, TrainMetrics): one optimizer step,
    updating `state` in place. `mesh` (`parallel.make_mesh`): `batch` is
    this rank's block of the global batch; the gradients are averaged over
    the data group before the clip and the metrics are the global batch's.
    `tx` may be `parallel.zero.ZeroOptimizer` (`--zero_opt`). `tp`
    (`parallel.tp.TensorParallel`): the state holds this rank's slices
    (`shard_state_tp`) and the model runs its local heads (`enable_tp`)."""
    loss_and_grads = make_loss_and_grads(model, masker, config, mesh)

    def train_step(state: Stage2State, batch: dict):
        loss, score, grads = loss_and_grads(state, batch)
        params = trainable(state, config)
        allreduce_grads_(grads, mesh)
        clip_by_global_norm_([grads[k] for k in params],
                             config.max_grad_norm,
                             None if tp is None
                             else [tp.is_split(k) for k in params], tp)
        tx.step(params, grads, state.opt_state)
        if masker.binarizer_name == "MaskedLinear2":
            # scheme 2's in-place clamp after every optimizer step
            with torch.no_grad():
                for s in state.scores.values():
                    clamp_scores_sign_(s)
        state.step += 1
        loss, score, size = reduce_metrics(
            loss, score, int(batch["labels"].shape[0]), mesh)
        return state, TrainMetrics(loss=loss, score=score, batch_size=size)

    return train_step


def make_threshold_reset(masker: Masker, tp=None) -> Callable:
    """fn(state) -> state: per-module k-th value thresholds, applied every
    logging_steps and before each export (mask_trainer_Robust_VQA.py:
    700-701, 726-733). Under tensor parallelism (`tp`) from the gathered
    scores: every rank gets the whole matrix's threshold, ties included."""

    def reset(state: Stage2State) -> Stage2State:
        state.thresholds = masker.reset_thresholds(full_scores(state, tp))
        return state

    return reset


def full_scores(state: Stage2State, tp=None) -> dict[str, torch.Tensor]:
    """The whole score matrices: gathered over the model group under
    tensor parallelism (a collective), else the state's."""
    return state.scores if tp is None else tp.gather(state.scores)


def shard_state_tp(state: Stage2State, tp) -> Stage2State:
    """Keep this rank's slices of the split leaves (frozen weights, scores,
    the moments and |grad| sums over them), in place; call after any
    resume, which loads whole leaves."""
    state.frozen = tp.shard(state.frozen)
    state.scores = tp.shard(state.scores)
    opt = state.opt_state
    opt.mu, opt.nu = tp.shard(opt.mu), tp.shard(opt.nu)
    if opt.abs_grad_sum is not None:
        opt.abs_grad_sum = tp.shard(opt.abs_grad_sum)
    return state


def make_eval_step(model: torch.nn.Module, masker: Masker,
                   config: Optional[Stage2Config] = None) -> Callable:
    """fn(state, batch) -> fp32 logits: the masked model in eval mode, no
    dropout and no randomness (`_prediction_loop`,
    mask_trainer_Robust_VQA.py:1096-1245)."""
    dtypes = param_dtypes(model)
    key = (config or Stage2Config()).classifier_key

    @torch.inference_mode()
    def eval_step(state: Stage2State, batch: dict) -> torch.Tensor:
        model.eval()
        # a fixed generator: eval is deterministic across batches (only
        # scheme 3's bernoulli binarizer draws from it)
        gen = torch.Generator(device=state.rng.device.device).manual_seed(0)
        params = masked_params(dtypes, masker, state, generator=gen,
                               classifier_key=key)
        logits, _ = functional_call(model, params, (), model_inputs(batch),
                                    strict=True)
        return logits

    return eval_step


def lxmert_meta_model(config) -> torch.nn.Module:
    """The LXMERT module on the meta device: structure and dtypes only; its
    parameters always come from the dict handed to functional_call."""
    from ..models import LxmertForVQA

    with torch.device("meta"):
        return LxmertForVQA(config)



def visualbert_meta_model(config) -> torch.nn.Module:
    """The VisualBERT module on the meta device (pair it with
    `Stage2Config(classifier_key="cls")`)."""
    from ..models import VisualBertForVQA

    with torch.device("meta"):
        return VisualBertForVQA(config)
