"""mPLUG training and answer generation (counterpart of
`crvqa_tpu/train/mplug_train.py`; the reference's `mPLUG/vqa_mplug.py:train`
:130-218 and beam evaluation :247-287).

One step computes the weighted, (1 - bias)-reweighted LM loss, takes
gradients with respect to the mask scores plus the LM-head parameters (mask
mode) or every parameter (full mode), clips them by one global norm and
applies the dual-rate `--opt` (`create_two_optimizer`: lr1 for the body,
lr2 for `visual_encoder`; AdamW by default, any name of the reference's
factory in `optim.py` / `timm_optim.py`; AdaHessian also takes the
Hutchinson diagonal) under the reference's schedules. With `distill` the
momentum twins (a second parameter dict, EMA'd from the live one before
every step, with their own EMA'd scores and thresholds in mask mode) supply
soft labels.

The model is built on the meta device and never holds weights: every call
runs `torch.func.functional_call` on the state's parameter dict with each
masked weight replaced by `w * binarize(s, t)` (`Masker.apply_masks`), as
stage 2 does. One reparametrisation covers a whole call (encode, the cross
K/V projections and the beam loop), through `MPlug.forward(fn, ...)`.

The state is updated IN PLACE by the step (the JAX package returns a new
state). Trained leaves are fp32 masters (scores and head parameters in mask
mode, every parameter in full mode, the twins always); frozen parameters are
held in the dtypes the model computes with, and each call casts the rest to
them, the cast the JAX package applies inside every module.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch
from torch.func import functional_call

from ..masking.masker import Masker
from ..models.layers import set_generators
from ..models.mplug import MPlug, momentum_update_
from ..models.mplug.generator import (beam_generate, init_self_caches,
                                      precompute_cross_kv)
from .common import (AdamWState, GroupAdamW, Schedule, TrainRNG,
                     allreduce_grads_, allreduce_mean_,
                     clip_by_global_norm_, hidden_dropout_generator)
from .optim import OptState, TwoGroupOptimizer, base_name, is_second_order


@dataclasses.dataclass(frozen=True)
class MPlugTrainConfig:
    mode: str = "mask"  # 'full' | 'mask'
    lr1: float = 3e-5  # body
    lr2: float = 5e-6  # visual encoder
    weight_decay: float = 0.02
    warmup_steps: int = 1000
    total_steps: int = 100_000
    min_lr: float = 1e-6
    sched: str = "cosine"  # cosine | tanh | step (scheduler_factory.py:10)
    decay_rate: float = 0.1  # 'step' schedule only
    decay_steps: int = 0  # 'step' schedule only
    # Epoch-granular driving (timm t_in_epochs=True): with steps_per_epoch >
    # 0 the rate follows `timm_epoch_schedule`, the trajectory of the
    # reference loop (yaml `schedular:` block: epochs 8, warmup_epochs 4,
    # warmup_lr 1e-5, decay_rate 1); 0 keeps the step-granular
    # `make_lr_schedule` driven by warmup_steps / total_steps.
    steps_per_epoch: int = 0
    epochs: int = 8
    warmup_epochs: int = 4
    warmup_lr_init: float = 1e-5
    decay_epochs: int = 1  # 'step' sched, epoch mode
    opt: str = "adamw"
    opt_momentum: float = 0.9  # sgd / nesterov / momentum / rmsprop / sgdp
    # / rmsproptf
    max_grad_norm: float = 1.0
    use_bias_reweight: bool = True  # the (1 - bias) * loss debias term
    distill: bool = False
    momentum: float = 0.995
    # distillation weight; ramps 0 -> alpha over the first
    # `alpha_warmup_steps` steps (one epoch), the reference's
    # `alpha * min(1, i / len(data_loader))` (vqa_mplug.py:165-168)
    alpha: float = 0.4
    alpha_warmup_steps: int = 0  # 0: no ramp
    # Mask mode keeps parameters whose name holds one of these substrings
    # trainable beside the scores (mPLUG/masking/maskers.py:620-626): the
    # decoder's LM-head transform and bias. The tied decoder weight IS the
    # frozen word embedding and has no parameter of its own.
    train_classifier: bool = True

    @property
    def head_substrings(self) -> tuple[str, ...]:
        return ("predictions", "classifier") if self.train_classifier else (
            "predictions",)


@dataclasses.dataclass
class MPlugState:
    """`params`: every parameter by state_dict name, on the device (fp32
    where trained, else the model's dtypes); `scores` / `thresholds` by spec
    key (mask mode), scores [out, in] fp32; the twins `params_m`,
    `scores_m`, `thresholds_m` (distill) fp32; `opt_state` and `rng` only
    in a training state."""

    params: dict[str, torch.Tensor]
    scores: Optional[dict[str, torch.Tensor]] = None
    thresholds: Optional[dict[str, torch.Tensor]] = None
    step: int = 0
    params_m: Optional[dict[str, torch.Tensor]] = None
    scores_m: Optional[dict[str, torch.Tensor]] = None
    thresholds_m: Optional[dict[str, torch.Tensor]] = None
    opt_state: Optional[Union[AdamWState, OptState]] = None
    rng: Optional[TrainRNG] = None


# ------------------------------------------------------------ name rules

def _parts(name: str) -> list[str]:
    """A trainable's name ('scores/<spec key>', 'head/<state_dict name>',
    'params/<state_dict name>') split into its path parts."""
    return name.replace("/", ".").split(".")


def split_head_params(params: dict[str, torch.Tensor],
                      substrings: Sequence[str]) -> dict[str, torch.Tensor]:
    """The parameters that stay trainable in mask mode: a name part holds
    one of `substrings`."""
    return {k: v for k, v in params.items()
            if any(s in part for part in k.split(".") for s in substrings)}


def merge_head_params(params: dict[str, torch.Tensor],
                      head: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    out = dict(params)
    out.update(head)
    return out


def two_group_labels(names: Iterable[str]) -> dict[str, str]:
    """'visual' for every name under visual_encoder (state_dict names and
    '/'-keyed score keys alike), 'body' otherwise."""
    return {n: "visual" if "visual_encoder" in _parts(n) else "body"
            for n in names}


def decay_mask(names: Iterable[str]) -> dict[str, bool]:
    """True where AdamW weight decay applies. The reference's no_decay list
    is ["bias", "LayerNorm.weight"] by SUBSTRING on the torch name
    (optim_factory.py:142-155): no decay where the last part holds 'bias'
    (score keys of bias masks too) or for a `...LayerNorm.weight`. The CLIP
    ViT names its norms ln_1 / ln_2 / ln_pre / ln_post, so their weights DO
    decay, as in the reference."""
    out = {}
    for n in names:
        parts = _parts(n)
        out[n] = not ("bias" in parts[-1] or (
            parts[-1] == "weight" and len(parts) > 1
            and parts[-2].endswith("LayerNorm")))
    return out


# -------------------------------------------------------------- schedules

def _linear(init: float, end: float, steps: int, count: float) -> float:
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def _cosine(lr: float, warmup: int, total: int, min_lr: float) -> Schedule:
    """`optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, warmup + 1), min_lr)`."""
    warmup_steps = max(warmup, 1)
    decay_steps = max(total, warmup + 1) - warmup_steps
    alpha = 0.0 if lr == 0.0 else min_lr / lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _linear(0.0, lr, warmup_steps, step)
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def timm_epoch_schedule(sched: str, lr: float, warmup_epochs: int,
                        epochs: int, min_lr: float, steps_per_epoch: int,
                        decay_rate: float = 1.0, decay_epochs: int = 1,
                        warmup_lr_init: float = 1e-5,
                        step_size: int = 100) -> Schedule:
    """The rate the reference mPLUG loop produces, as a function of the
    global step. The loop drives the vendored timm schedulers by epoch:
    during epoch 0 it advances the warm-up one unit every `step_size`
    iterations while i <= warmup_epochs * step_size (vqa_mplug.py:145-146,
    200-201), and at each epoch's end calls `step(epoch + warmup_epochs)`
    (:431), so epoch e >= 1 runs at `_get_lr(e - 1 + warmup_epochs)`.

    - cosine (cosine_lr.py:68-95, warmup_prefix): linear warmup_lr_init ->
      lr over warmup_epochs units, then gamma^i * (min_lr + (lr - min_lr) /
      2 * (1 + cos(pi * t / epochs))) on the post-warm-up clock; min_lr once
      the cycle is exhausted;
    - tanh (tanh_lr.py:64-99): the ramp ends at the tanh value AT
      t = warmup_epochs, and the tanh clock includes the warm-up span;
    - step (step_lr.py:46-51): lr * decay_rate^(t // decay_epochs), no
      floor."""
    spe = max(int(steps_per_epoch), 1)
    warmup_t = int(warmup_epochs)
    t_initial = max(int(epochs), 1)
    # warm-up units that fire inside epoch 0
    cap = min(warmup_t, (spe - 1) // step_size) if warmup_t > 0 else 0

    def decay_lr(tf: float) -> float:
        if sched == "cosine":
            td = tf - warmup_t
            i = math.floor(td / t_initial)
            t_curr = td - i * t_initial
            val = decay_rate ** i * (min_lr + 0.5 * (lr - min_lr) * (
                1.0 + math.cos(math.pi * t_curr / t_initial)))
            return val if i < 1 else min_lr
        if sched == "tanh":
            lb, ub = -6.0, 4.0
            i = math.floor(tf / t_initial)
            tr = (tf - i * t_initial) / t_initial
            gamma = decay_rate ** i
            val = gamma * min_lr + 0.5 * (lr - min_lr) * gamma * (
                1.0 - math.tanh(lb * (1.0 - tr) + ub * tr))
            return val if i < 1 else min_lr * decay_rate
        if sched == "step":
            return lr * decay_rate ** math.floor(tf / max(int(decay_epochs),
                                                          1))
        raise ValueError(f"unsupported sched '{sched}'")

    warm_target = (decay_lr(float(warmup_t))
                   if sched == "tanh" and warmup_t > 0 else lr)

    def schedule(step: int) -> float:
        s = int(step)
        e = s // spe
        t = min(max((s - 1) // step_size, 0), cap) if e == 0 else (
            e - 1 + warmup_t)
        if warmup_t > 0 and t < warmup_t:
            return warmup_lr_init + t * (warm_target
                                         - warmup_lr_init) / warmup_t
        return decay_lr(float(t))

    return schedule


def make_lr_schedule(sched: str, lr: float, warmup: int, total: int,
                     min_lr: float, decay_rate: float = 0.1,
                     decay_steps: int = 0) -> Schedule:
    """The reference's scheduler factory as step-granular schedules
    (scheduler_factory.py:10-90): cosine = warm-up then cosine to min_lr;
    tanh = min_lr + (lr - min_lr) / 2 * (1 - tanh(-6 (1 - tr) + 4 tr)) after
    a linear warm-up; step = lr * decay_rate^((t - warmup) // decay_steps),
    floored at min_lr. 'plateau' is metric-driven and raises."""
    if sched == "cosine":
        return _cosine(lr, warmup, total, min_lr)
    warmup = max(warmup, 1)
    if sched == "tanh":
        span = max(total - warmup, 1)

        def tanh_sched(step: int) -> float:
            if step < warmup:
                return lr * step / warmup
            tr = min(max((step - warmup) / span, 0.0), 1.0)
            return min_lr + 0.5 * (lr - min_lr) * (
                1.0 - math.tanh(-6.0 * (1.0 - tr) + 4.0 * tr))

        return tanh_sched
    if sched == "step":
        d = max(decay_steps, 1)

        def step_sched(step: int) -> float:
            val = (lr * step / warmup if step < warmup else
                   lr * decay_rate ** math.floor((step - warmup) / d))
            return max(val, min_lr)

        return step_sched
    raise ValueError(f"unsupported sched '{sched}' (cosine|tanh|step; "
                     "'plateau' is metric-driven and unused by any shipped "
                     "reference config)")


def make_two_group_adamw(config: MPlugTrainConfig, names: Iterable[str]):
    """The dual-rate optimizer over the trainables `names`
    (`create_two_optimizer`, mPLUG/optim/optim_factory.py:141-171):
    `visual_encoder` leaves at lr2, everything else at lr1, bias and
    LayerNorm weights undecayed. The inner optimizer is `config.opt`
    (default adamw, the shipped choice: `GroupAdamW`; the rest of the
    factory's table: `optim.TwoGroupOptimizer`, which raises ValueError
    for a name outside it; adahessian: `timm_optim.AdaHessian`, which
    clips its own gradients). For the others the caller clips by one
    global norm over the whole trainable set first (`make_train_step`)."""

    def sched(lr: float) -> Schedule:
        if config.steps_per_epoch > 0:
            return timm_epoch_schedule(
                config.sched, lr, config.warmup_epochs, config.epochs,
                config.min_lr, config.steps_per_epoch,
                decay_rate=config.decay_rate,
                decay_epochs=config.decay_epochs,
                warmup_lr_init=config.warmup_lr_init)
        return make_lr_schedule(config.sched, lr, config.warmup_steps,
                                config.total_steps, config.min_lr,
                                config.decay_rate, config.decay_steps)

    names = list(names)
    schedules = {"body": sched(config.lr1), "visual": sched(config.lr2)}
    groups, decay = two_group_labels(names), decay_mask(names)
    if is_second_order(config.opt):
        from .timm_optim import AdaHessian

        return AdaHessian(schedules, groups, decay,
                          weight_decay=config.weight_decay,
                          max_grad_norm=config.max_grad_norm)
    if base_name(config.opt) in ("adamw", "fusedadamw"):
        return GroupAdamW(schedules, groups, decay,
                          weight_decay=config.weight_decay)
    return TwoGroupOptimizer(config.opt, schedules, groups, decay,
                             weight_decay=config.weight_decay,
                             momentum=config.opt_momentum)


# ------------------------------------------------------------------ state

def param_dtypes(model: torch.nn.Module) -> dict[str, torch.dtype]:
    return {n: p.dtype for n, p in model.named_parameters()}


def trainable(state: MPlugState, config: MPlugTrainConfig
              ) -> dict[str, torch.Tensor]:
    """The optimizer's flat view of what it steps: 'scores/<key>' and
    'head/<name>' in mask mode, 'params/<name>' in full mode."""
    if config.mode == "mask":
        out = {f"scores/{k}": v for k, v in state.scores.items()}
        out.update({f"head/{k}": v for k, v in split_head_params(
            state.params, config.head_substrings).items()})
        return out
    return {f"params/{k}": v for k, v in state.params.items()
            if v.dtype.is_floating_point}


def init_state(model: torch.nn.Module, params: dict[str, torch.Tensor],
               config: MPlugTrainConfig, device,
               masker: Optional[Masker] = None, seed: int = 0,
               train: bool = False) -> MPlugState:
    """A state from a full fp32 state_dict. In mask mode the scores and
    thresholds come from the fp32 weights (`masker.init`, as the JAX
    package inits them from its fp32 params; the random inits draw from a
    generator seeded with `seed`). Frozen parameters are then cast to the
    dtypes the model computes with.

    `train`: the trained leaves stay fp32 and require gradients, the
    optimizer state and the generators are built, and with `config.distill`
    the twins start as fp32 copies of the parameters, scores and
    thresholds (the reference's copy_params, model_vqa_mplug.py:139-148)."""
    device = torch.device(device)
    params = {k: v.to(device) for k, v in params.items()}
    scores = thresholds = None
    if config.mode == "mask":
        if masker is None:
            raise ValueError("mask mode needs a masker")
        scores, thresholds = masker.init(
            params, torch.Generator(device=device).manual_seed(seed))
    dtypes = param_dtypes(model)
    if not train:
        return MPlugState(params={n: t.to(dtypes[n])
                                  for n, t in params.items()},
                          scores=scores, thresholds=thresholds)
    state = MPlugState(params=params, scores=scores, thresholds=thresholds,
                       rng=TrainRNG.from_seed(seed, device))
    if config.distill:
        state.params_m = {k: v.detach().clone() for k, v in params.items()}
        if scores is not None:
            state.scores_m = {k: v.detach().clone()
                              for k, v in scores.items()}
            state.thresholds_m = {k: v.detach().clone()
                                  for k, v in thresholds.items()}
    trained = {id(t) for t in trainable(state, config).values()}
    state.params = {n: (t if id(t) in trained else t.to(dtypes[n]))
                    for n, t in params.items()}
    leaves = trainable(state, config)
    for t in leaves.values():
        t.requires_grad_(True)
    state.opt_state = make_two_group_adamw(config, leaves).init(leaves)
    return state


def _cast(params: dict[str, torch.Tensor], dtypes: dict[str, torch.dtype]
          ) -> dict[str, torch.Tensor]:
    return {n: (t if t.dtype == dtypes[n] else t.to(dtypes[n]))
            for n, t in params.items()}


def masked_params(model: torch.nn.Module, masker: Optional[Masker],
                  state: MPlugState) -> dict[str, torch.Tensor]:
    """The model's parameter dict from the live state: masks applied (when
    a masker and scores are given), every leaf in the model's dtype.
    Differentiable in the scores and in fp32 master parameters."""
    params = state.params
    if masker is not None and state.scores is not None:
        params = masker.apply_masks(params, state.scores, state.thresholds)
    return _cast(params, param_dtypes(model))


def run_masked(model: torch.nn.Module, masker: Optional[Masker],
               state: MPlugState, fn: Callable, *args):
    """fn(model, *args) in eval mode, without autograd, on the state's
    masked parameters."""
    model.eval()
    with torch.inference_mode():
        return functional_call(model, masked_params(model, masker, state),
                               (fn, *args), strict=True)


# ------------------------------------------------------------- train step

_BATCH_KEYS = ("images", "question_ids", "question_mask", "answer_ids",
               "answer_mask")


def make_loss_and_grads(model: torch.nn.Module, config: MPlugTrainConfig,
                        masker: Optional[Masker] = None,
                        mesh=None) -> Callable:
    """fn(state, batch) -> (loss, grads keyed as `trainable`): with
    `distill`, the twins' EMA update and their soft labels first; then the
    forward on the (masked) model in training mode, dropout drawing from
    the state's generators, and the backward. `batch` holds device tensors
    "images", "question_ids", "question_mask", "answer_ids" / "answer_mask"
    [B, A, L], "weights" [B, A] and optionally "bias" [B, A].

    Under adahessian (`config.opt`) fn(state, batch, z=None) -> (loss,
    grads, hess): the Hutchinson diagonal z * (H @ z) from one Rademacher
    probe per trainable leaf (`timm_optim.hutchinson`), drawn from the
    state's device generator before the forward unless `z` is given.

    With a data-parallel `mesh` the batch is this rank's block and the
    results are local; the device generator (the probe) draws the same on
    every rank, the hidden dropout from `hidden_dropout_generator`."""
    dtypes = param_dtypes(model)
    mask_mode = config.mode == "mask"
    if mask_mode and masker is None:
        raise ValueError("mask mode needs a masker")
    second_order = is_second_order(config.opt)

    def soft_labels(state: MPlugState, batch: dict) -> torch.Tensor:
        """Momentum twins -> soft labels (model_vqa_mplug.py:65-92), the
        twins masked with their OWN EMA'd scores and thresholds."""
        params_m = state.params_m
        if mask_mode:
            params_m = masker.apply_masks(params_m, state.scores_m,
                                          state.thresholds_m,
                                          momentum_tree=True)
        model.eval()
        with torch.no_grad():
            logits_m = functional_call(
                model, _cast(params_m, dtypes),
                (MPlug.answer_logits, *(batch[k] for k in _BATCH_KEYS)),
                strict=True)
            return torch.softmax(logits_m[:, :-1].float(), dim=-1)

    def loss_and_grads(state: MPlugState, batch: dict, z=None):
        soft, alpha = None, 0.0
        if config.distill:
            # EMA the twins BEFORE they produce the soft labels, like
            # _momentum_update at the top of the reference's distill branch
            momentum_update_(state.params_m, state.params, config.momentum)
            if mask_mode:
                momentum_update_(state.scores_m, state.scores,
                                 config.momentum)
            soft = soft_labels(state, batch)
            alpha = config.alpha
            if config.alpha_warmup_steps:
                alpha *= min(1.0, state.step / config.alpha_warmup_steps)
        leaves = trainable(state, config)
        bias = batch.get("bias") if config.use_bias_reweight else None

        def loss_fn(_leaves: dict) -> torch.Tensor:
            # the leaves ARE the state's tensors: the forward reads them
            model.train()
            set_generators(model, hidden_dropout_generator(
                state.rng, state.step, mesh), state.rng.host,
                mesh.data_index if mesh else 0)
            return functional_call(
                model,
                masked_params(model, masker if mask_mode else None, state),
                (MPlug.loss, *(batch[k] for k in _BATCH_KEYS),
                 batch["weights"]),
                dict(bias=bias, soft_labels=soft, alpha=alpha), strict=True)

        if second_order:
            from .timm_optim import hutchinson

            return hutchinson(loss_fn, leaves, state.rng.device, z=z)
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return loss.detach(), grads

    return loss_and_grads


def reduce_loss(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's loss: the mean of the data ranks' (mPLUG's
    `sum(loss) / b` over equal blocks averages to the global one)."""
    allreduce_mean_([loss], mesh)
    return loss


def make_train_step(model: torch.nn.Module, config: MPlugTrainConfig,
                    masker: Optional[Masker] = None, mesh=None,
                    zero=None) -> Callable:
    """fn(state, batch) -> (state, loss): one optimizer step, updating
    `state` in place: `make_loss_and_grads`, one global-norm clip over the
    whole trainable set, then the two-group optimizer (adahessian: the
    (grads, hess) pair to `AdaHessian`, which clips the gradients
    itself). `mesh`: `batch` is this rank's block; gradients (and the
    Hessian diagonal) are averaged over the data group and the returned
    loss is the global batch's. `zero` (`parallel.zero.ZeroPartition`):
    the optimizer state is sharded by it (`ZeroOptimizer`)."""
    loss_and_grads = make_loss_and_grads(model, config, masker, mesh)
    second_order = is_second_order(config.opt)
    tx: list = []  # built at the first step, from its leaves

    def train_step(state: MPlugState, batch: dict):
        leaves = trainable(state, config)
        if not tx:
            opt = make_two_group_adamw(config, leaves)
            if zero is not None:
                from ..parallel.zero import ZeroOptimizer

                opt = ZeroOptimizer(opt, zero)
            tx.append(opt)
        if second_order:
            loss, grads, hess = loss_and_grads(state, batch)
            allreduce_grads_(grads, mesh)
            allreduce_grads_(hess, mesh)
            tx[0].step(leaves, (grads, hess), state.opt_state)
        else:
            loss, grads = loss_and_grads(state, batch)
            allreduce_grads_(grads, mesh)
            clip_by_global_norm_(list(grads.values()), config.max_grad_norm)
            tx[0].step(leaves, grads, state.opt_state)
        state.step += 1
        return state, reduce_loss(loss, mesh)

    return train_step


def make_threshold_reset(masker: Masker) -> Callable:
    """fn(state, target=None) -> state: every module's threshold := the
    k-th value of its scores at `target` (the MaskerScheduler's moving
    target; None = the masker's zero rate), driven every
    `masker_update_step` steps by the caller (vqa_mplug.py:206-212). The
    twins' thresholds come from the twins' own EMA'd scores
    (maskers.py:689-711 walks every patched module)."""

    def reset(state: MPlugState, target: Optional[float] = None
              ) -> MPlugState:
        state.thresholds = masker.reset_thresholds(state.scores, target)
        if state.scores_m is not None:
            state.thresholds_m = masker.reset_thresholds(state.scores_m,
                                                         target)
        return state

    return reset


# --------------------------------------------------------------- generate

def make_generate_step(model: torch.nn.Module, config: MPlugTrainConfig,
                       masker: Optional[Masker] = None, beam_size: int = 5,
                       max_len: int = 12, min_length: int = 1,
                       lp_alpha: float = 0.6,
                       use_cache: bool = True) -> Callable:
    """generate(state, batch) -> (best ids [B, max_len], best scores [B]):
    beam search (`vqa_mplug.py:247-287`) over the fused states, the cross
    K/V projected once from the unreplicated memory and each item's beams
    grouped over it (`memory_groups`); `use_cache` decodes incrementally
    with self-attention KV caches. `batch` holds device tensors "images",
    "question_ids", "question_mask"."""
    mcfg = model.config
    bc = mcfg.bert

    def run(m, images, question_ids, question_mask):
        states, state_mask = m.encode(images, question_ids, question_mask)
        cross_kv = precompute_cross_kv(m.text_decoder, states,
                                       bc.text_decode_layers,
                                       bc.num_attention_heads, bc.head_size,
                                       dtype=bc.dtype)

        def decode(ids, mask, st, st_mask, position):
            return m.decode_logits(ids, mask, st, st_mask, cross_kv=cross_kv,
                                   position=position,
                                   memory_groups=beam_size)

        decode_step = init_caches = None
        if use_cache:
            init_caches = init_self_caches(
                states.shape[0] * beam_size, bc.text_decode_layers, max_len,
                bc.num_attention_heads, bc.head_size, dtype=bc.dtype,
                device=states.device)

            def decode_step(ids, st, st_mask, position, caches):
                return m.decode_logits_step(ids, st, st_mask, position,
                                            caches, cross_kv=cross_kv,
                                            memory_groups=beam_size)

        return beam_generate(decode, states, state_mask,
                             beam_size=beam_size, max_len=max_len,
                             bos=mcfg.bos_token_id, eos=mcfg.eos_token_id,
                             pad=mcfg.pad_token_id, min_length=min_length,
                             lp_alpha=lp_alpha, group_memory=True,
                             decode_step=decode_step,
                             init_caches=init_caches)

    def generate(state: MPlugState, batch: dict):
        mask = masker if config.mode == "mask" else None
        return run_masked(model, mask, state, run, batch["images"],
                          batch["question_ids"], batch["question_mask"])

    return generate


def mplug_meta_model(config) -> torch.nn.Module:
    """The mPLUG module on the meta device: structure and dtypes only."""
    with torch.device("meta"):
        return MPlug(config)
