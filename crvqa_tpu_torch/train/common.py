"""Shared training-step machinery (counterpart of `crvqa_tpu/train/common.py`):
the reference's AdamW (stage 2), an `optax.adamw` twin over parameter groups
(mPLUG), the stage-1/3 Adam, clip-by-global-norm, the linear warmup
schedule, the generators a training state carries and the batch helpers.

The JAX package's optimizers are pure functions over pytrees; here the
optimizer updates parameters and moments IN PLACE (no second copy of the
210M mask scores or their moments), over flat dicts of tensors, with
PyTorch's multi-tensor (`torch._foreach_*`) ops. The arithmetic is the JAX
package's, step for step.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int
                           ) -> Schedule:
    """`get_linear_schedule_with_warmup` (hg_transformers/optimization.py),
    as the JAX package spells it with optax: a linear ramp from 0 to lr
    over `warmup_steps`, then linear decay to 0 over the rest of
    `total_steps` (at least one step); constant past the end."""
    def ramp(init: float, end: float, steps: int, count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    if warmup_steps > 0:
        decay = max(total_steps - warmup_steps, 1)
        return lambda c: (ramp(0.0, lr, warmup_steps, c) if c < warmup_steps
                          else ramp(lr, 0.0, decay, c - warmup_steps))
    return lambda c: ramp(lr, 0.0, max(total_steps, 1), c)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         split: Optional[list[bool]] = None, tp=None) -> None:
    """optax.clip_by_global_norm in place: every gradient scaled by
    max_norm / ||g|| when the global norm ||g|| (over all of them) reaches
    max_norm; on the device, with no host sync. Under tensor parallelism
    (`tp`, `parallel.tp.TensorParallel`) the gradients flagged in `split`
    are this rank's slices: their squares are summed over the model group
    and the replicated ones counted once, so ||g|| is the whole model's,
    as the JAX package takes it over global arrays."""
    norms = torch.stack(torch._foreach_norm(grads))
    if tp is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        import torch.distributed as dist

        squares = norms.float() ** 2
        flags = torch.tensor(split, device=norms.device)
        sharded = torch.where(flags, squares, 0.0).sum()
        dist.all_reduce(sharded, group=tp.mesh.model_group)
        norm = torch.sqrt(sharded + torch.where(flags, 0.0, squares).sum())
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)


# elements per all-reduce bucket: a flat copy of at most 256 MB in fp32
_BUCKET_ELEMS = 1 << 26


def _buckets(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """`tensors` grouped by dtype, in their order, into buckets of at most
    `_BUCKET_ELEMS` elements (a larger tensor is a bucket alone): the
    same buckets on every rank, so reductions are deterministic."""
    by_dtype: dict[torch.dtype, list[list[torch.Tensor]]] = {}
    for t in tensors:
        groups = by_dtype.setdefault(t.dtype, [[]])
        if groups[-1] and (sum(x.numel() for x in groups[-1]) + t.numel()
                           > _BUCKET_ELEMS):
            groups.append([])
        groups[-1].append(t)
    return [b for groups in by_dtype.values() for b in groups if b]


@torch.no_grad()
def allreduce_mean_(tensors: list[torch.Tensor], mesh) -> None:
    """Each tensor := its mean over `mesh`'s data group, in place, through
    fixed-order flat buckets per dtype. A no-op without a process group; at
    world 1 the sum over one rank and the division by 1 keep every bit."""
    if mesh is None or not mesh.distributed or not tensors:
        return
    import torch.distributed as dist

    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=mesh.data_group)
        flat.div_(mesh.data)
        for t, f in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(f.view_as(t))


def allreduce_grads_(grads: dict[str, torch.Tensor], mesh) -> None:
    """Data-parallel gradients: each := its mean over the data group (the
    JAX loss is a mean over the global batch, and the mean of equal-sized
    local means equals it). Call between the backward and the clip."""
    allreduce_mean_(list(grads.values()), mesh)


@torch.no_grad()
def reduce_metrics(loss: torch.Tensor, score: torch.Tensor,
                   batch_size: int, mesh
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The step's logged numbers over the data group: the loss a mean,
    the summed score and the batch size sums. The inputs themselves
    without a process group."""
    if mesh is None or not mesh.distributed:
        return loss, score, batch_size
    import torch.distributed as dist

    both = torch.stack([loss.float(), score.float()])
    dist.all_reduce(both, group=mesh.data_group)
    return both[0] / mesh.data, both[1], batch_size * mesh.data


def hidden_dropout_generator(rng: "TrainRNG", step: int, mesh
                             ) -> torch.Generator:
    """The generator of the hidden (and eager attention) dropout masks at
    `step`. At data 1 it is the state's device generator itself, so a run
    keeps its single-process masks. With several data ranks each rank
    draws from its own generator, seeded from the device generator's seed,
    the step and its `data_index`: data ranks draw independent masks for
    their different rows, tensor-parallel partners the same, and the
    device generator (MaskedLinear3's bernoulli, Hutchinson's probe) stays
    in step on every rank. The attention kernels' masks need no such
    generator: their counter hash is keyed on the global row."""
    if mesh is None or mesh.data == 1:
        return rng.device
    seed = rng.device.initial_seed()
    mixed = ((seed * 1000003 + step) * 1000003 + mesh.data_index) % 2 ** 63
    return torch.Generator(device=rng.device.device).manual_seed(mixed)


@dataclasses.dataclass
class HfAdamWState:
    """`count` steps taken; first and second moments and (when on) the
    |grad| accumulator, keyed like the parameters."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    abs_grad_sum: Optional[dict[str, torch.Tensor]]


class HfAdamW:
    """The reference's custom AdamW (root `optimization.py:8-129`), as the
    JAX package's `hf_adamw`:

      m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
      step = lr * sqrt(1 - b2^t) / (1 - b1^t)
      u = -step * m / (sqrt(v) + eps)            (eps OUTSIDE the bias
                                                  correction)
      u -= lr * weight_decay * (p + u)           (decay of the updated p)
      p += u

    The schedule is read at the PRE-increment count (torch's LambdaLR
    steps after optimizer.step()); the bias correction uses the
    post-increment count. `grad_mask` multiplies gradients before the
    moments; without it, `accumulate_abs_grad` integrates |g| per step.
    `moment_dtype` (e.g. torch.bfloat16) stores m and v narrower while each
    step's moment math stays fp32."""

    def __init__(self, learning_rate: Union[float, Schedule],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0,
                 grad_mask: Optional[dict[str, torch.Tensor]] = None,
                 accumulate_abs_grad: bool = False,
                 moment_dtype: Optional[torch.dtype] = None):
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda _: learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_mask = grad_mask
        self.accumulate_abs_grad = accumulate_abs_grad
        self.moment_dtype = moment_dtype

    def init(self, params: dict[str, torch.Tensor]) -> HfAdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype
                                           or p.dtype)
        sums = ({k: torch.zeros_like(p) for k, p in params.items()}
                if self.accumulate_abs_grad and self.grad_mask is None
                else None)
        return HfAdamWState(0, {k: zeros(p) for k, p in params.items()},
                            {k: zeros(p) for k, p in params.items()}, sums)

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: HfAdamWState) -> None:
        """One update of `params` (in place) from `grads`; advances
        `state` in place."""
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        if self.grad_mask is not None:
            g = torch._foreach_mul(g, [self.grad_mask[k] for k in keys])
        if state.abs_grad_sum is not None:
            torch._foreach_add_([state.abs_grad_sum[k] for k in keys],
                                torch._foreach_abs(g))
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        narrow = self.moment_dtype is not None
        m = [x.float() for x in mu] if narrow else mu
        v = [x.float() for x in nu] if narrow else nu
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)

        lr = float(self.schedule(state.count))
        state.count += 1
        c = state.count
        step_size = lr * math.sqrt(1.0 - self.b2 ** c) / (1.0 - self.b1 ** c)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(m, denom)
        torch._foreach_mul_(u, -step_size)
        if self.weight_decay > 0.0:
            decay = torch._foreach_add(p, u)
            torch._foreach_mul_(decay, lr * self.weight_decay)
            torch._foreach_sub_(u, decay)
        torch._foreach_add_(p, u)
        if narrow:
            for dst, src in zip(mu + nu, m + v):
                dst.copy_(src)


@dataclasses.dataclass
class TrainRNG:
    """The generators a training state carries. `device`: dropout masks
    (and scheme 3's bernoulli); `host` (CPU): the attention kernels'
    per-call dropout seeds.

    A JAX training state carries a PRNG key instead (uint32 words). Its
    streams cannot be reproduced by torch's generators, so the key only
    seeds them, by one rule (`from_jax_key`): the words read as one
    big-endian integer s modulo 2^64 seed `device` with s and `host` with
    s + 1 (mod 2^64). The key `PRNGKey(n)` of a `--seed n` run, [0, n],
    so gives the generators of `from_seed(n)`, and two resumes of one file
    draw the same numbers. `to_jax_key` goes back: the key the generators
    were made from while they have drawn nothing since, else two words of
    the SHA-256 of both generators' states (a key no earlier run drew
    from, the same for the same states)."""

    device: torch.Generator
    host: torch.Generator
    key: Optional[np.ndarray] = None  # the uint32 words of the seed
    seeded: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_seed(cls, seed: int, device) -> "TrainRNG":
        seed %= 2 ** 64
        rng = cls(torch.Generator(device=device).manual_seed(seed),
                  torch.Generator().manual_seed((seed + 1) % 2 ** 64))
        rng.key = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
        rng.seeded = rng._states()
        return rng

    @classmethod
    def from_jax_key(cls, key, device) -> "TrainRNG":
        words = np.asarray(key, np.uint32).reshape(-1)
        seed = 0
        for w in words:
            seed = (seed << 32 | int(w)) % 2 ** 64
        rng = cls.from_seed(seed, device)
        rng.key = words.copy()
        return rng

    def _states(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.device.get_state(), self.host.get_state()

    def to_jax_key(self) -> np.ndarray:
        states = self._states()
        if self.key is not None and self.seeded is not None and all(
                torch.equal(a, b) for a, b in zip(states, self.seeded)):
            return self.key.copy()
        digest = hashlib.sha256(b"".join(
            s.cpu().numpy().tobytes() for s in states)).digest()
        return np.frombuffer(digest[:8], ">u4").astype(np.uint32)


@dataclasses.dataclass
class AdamWState:
    """`count` steps taken; first and second moments keyed like the
    parameters."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax forms it from its int32 count
    (`tree_bias_correction`): at b2 = 0.999 the float32 value differs from
    the exact one by about 1e-5 relative in the first steps."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class GroupAdamW:
    """`optax.adamw(schedule, weight_decay=wd, mask=decay)` under
    `optax.multi_transform`, in place over a flat dict of tensors:

      m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
      u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)   (eps on the
                                 bias-corrected moments; 1 - b^t in float32)
      u += weight_decay * p          (only where `decay[name]`; decoupled)
      p += -lr_group(t - 1) * u      (the schedule at the PRE-increment
                                      count, the bias correction at t)

    `groups[name]` names each parameter's group and `schedules[group]` its
    learning-rate schedule; every group shares one count. It is not
    `HfAdamW`: there eps sits outside the bias correction and the decay
    multiplies the updated parameter."""

    def __init__(self, schedules: dict[str, Schedule], groups: dict[str, str],
                 decay: dict[str, bool], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.schedules, self.groups, self.decay = schedules, groups, decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                          {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: AdamWState) -> None:
        """One update of `params` (in place) from `grads`; advances
        `state` in place."""
        keys = list(params)
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        lrs = {name: float(fn(state.count))
               for name, fn in self.schedules.items()}
        state.count += 1
        c = state.count
        denom = torch._foreach_div(nu, bias_correction(self.b2, c))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bias_correction(self.b1, c))
        torch._foreach_div_(u, denom)
        del denom
        updates = dict(zip(keys, u))
        if self.weight_decay > 0.0:
            decayed = [k for k in keys if self.decay[k]]
            torch._foreach_add_([updates[k] for k in decayed],
                                [params[k] for k in decayed],
                                alpha=self.weight_decay)
        for name, lr in lrs.items():
            members = [k for k in keys if self.groups[k] == name]
            if members:
                torch._foreach_add_([params[k] for k in members],
                                    [updates[k] for k in members], alpha=-lr)


class Adam:
    """The stage-1/3 optimizer, `make_adam` of the JAX package
    (crvqa_tpu/train/common.py:214; `torch.optim.Adam` + linear warmup,
    `run_vqa_stage1.py:341-362`), in place over a flat dict of tensors:
    every gradient is first clipped by the global norm (`max_grad_norm`),
    then

      m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
      p -= lr(t - 1) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

    with the schedule at the PRE-increment count and no weight decay
    (`optax.adam`). With `moment_dtype` (e.g. torch.bfloat16) m and v are
    stored narrower while each step's math stays fp32, in `torch_adam`'s
    arrangement (:163): p -= lr / (1 - b1^t) * m / (sqrt(v) /
    sqrt(1 - b2^t) + eps)."""

    def __init__(self, learning_rate: Union[float, Schedule],
                 max_grad_norm: Optional[float] = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: Optional[torch.dtype] = None):
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda _: learning_rate))
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = moment_dtype

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype
                                           or p.dtype)
        return AdamWState(0, {k: zeros(p) for k, p in params.items()},
                          {k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: AdamWState) -> None:
        """Clip `grads` (in place), then update `params` and `state` in
        place."""
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        if self.max_grad_norm is not None:
            clip_by_global_norm_(g, self.max_grad_norm)
        narrow = self.moment_dtype is not None
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        m = [x.float() for x in mu] if narrow else mu
        v = [x.float() for x in nu] if narrow else nu
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        lr = float(self.schedule(state.count))
        state.count += 1
        c = state.count
        if narrow:
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** c))
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(m, denom)
            torch._foreach_add_(p, u, alpha=-lr / (1.0 - self.b1 ** c))
            for dst, src in zip(mu + nu, m + v):
                dst.copy_(src)
            return
        denom = torch._foreach_div(v, 1.0 - self.b2 ** c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(m, 1.0 - self.b1 ** c)
        torch._foreach_div_(u, denom)
        torch._foreach_add_(p, u, alpha=-lr)


def make_adam(lr: float, warmup_steps: int, total_steps: int,
              max_grad_norm: float = 1.0, eps: float = 1e-8,
              moment_dtype: Optional[torch.dtype] = None) -> Adam:
    """The stage-1/3 optimizer with the linear warmup schedule
    (`make_adam`, crvqa_tpu/train/common.py:214)."""
    return Adam(linear_warmup_schedule(lr, warmup_steps, total_steps),
                max_grad_norm=max_grad_norm, eps=eps,
                moment_dtype=moment_dtype)


def batch_score(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """VQA soft accuracy summed over the batch: labels[argmax(logits)]
    (`compute_score_with_logits`, data/metrics/__init__.py:90-104)."""
    idx = torch.argmax(logits, dim=1)
    return torch.gather(labels, 1, idx[:, None]).sum()


@dataclasses.dataclass
class TrainMetrics:
    loss: torch.Tensor
    score: torch.Tensor  # summed soft accuracy over the batch
    batch_size: int


def model_inputs(batch: dict) -> dict:
    """Forward kwargs of a batch: LXMERT batches carry (visual_feats,
    visual_pos), VisualBERT batches visual_embeds
    (`mask_trainer_visualBERT_VQA.py:820` passes only input_ids and
    visual_embeds)."""
    kw = {"input_ids": batch["input_ids"]}
    if "visual_embeds" in batch:
        kw["visual_embeds"] = batch["visual_embeds"]
    else:
        kw["visual_feats"] = batch["visual_feats"]
        kw["visual_pos"] = batch["visual_pos"]
    if "attention_mask" in batch:
        kw["attention_mask"] = batch["attention_mask"]
    return kw
