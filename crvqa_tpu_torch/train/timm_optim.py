"""The timm optimizers of the reference's factory that optax lacks (the
port's counterpart of `crvqa_tpu/train/timm_optim.py`), over flat dicts of
tensors, in place.

- AdamP / SGDP (`mPLUG/optim/adamp.py`, `sgdp.py`; arXiv 2006.08217): the
  momentum update of a scale-invariant parameter (a low |cos| between
  gradient and parameter under the channel or the layer view) is
  projected off the parameter's radial direction, and its weight decay
  damped by `wd_ratio`. The decay is the torch classes' shrink before the
  step, every leaf, the schedule read at the incremented count.
- RMSpropTF (`mPLUG/optim/rmsprop_tf.py`): square average started at ONES,
  eps inside the square root, coupled decay, the learning rate folded into
  the momentum buffer.
- AdaHessian (`mPLUG/optim/adahessian.py`; arXiv 2006.00719): `hutchinson`
  gives (loss, grads, z * (H @ z)) for one Rademacher probe z; the JAX
  package takes H @ z forward-over-reverse, the port reverse-over-reverse
  (a second backward of <grads, z> through the create_graph backward),
  which is the same vector for a symmetric Hessian: the straight-through
  binarizers' surrogate is one (tests/test_torch_optim.py).
  `AdaHessian` owns its clip, grouping and decay, because its input is
  the (grads, hess) pair.
- `PlateauLR` (torch `ReduceLROnPlateau`'s decisions as a host-side
  controller) and `DynamicScale` / `set_dynamic_scale` (a scale held in
  the optimizer's state that multiplies the updates). No CLI of either
  package drives these two; they are library code.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .common import bias_correction
from .optim import OptState, Schedule


def _views(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(channel view [C, -1], layer view [1, -1]) of a >=2-D parameter."""
    return x.reshape(x.shape[0], -1), x.reshape(1, -1)


def _cosine_max(gv, pv, eps) -> torch.Tensor:
    """max over rows of |<g, p>| / (|g| + eps) / (|p| + eps): norms are
    eps-added, not clamped (adamp.py:_cosine_similarity)."""
    gn = torch.linalg.vector_norm(gv, dim=1) + eps
    pn = torch.linalg.vector_norm(pv, dim=1) + eps
    dot = torch.abs(torch.sum(gv * pv, dim=1))
    return torch.max(dot / gn / pn)


def _projection(p, grad, perturb, delta, wd_ratio, eps):
    """adamp.py:_projection: the first view (channel, then layer) whose
    largest cosine similarity is below delta / sqrt(view width) projects
    `perturb` off the parameter's direction and damps the decay by
    `wd_ratio`. Both projections are formed and one selected on the
    device, as the JAX function does. Returns (perturb, decay factor)."""
    if p.dim() <= 1:
        return perturb, 1.0
    expand = (-1,) + (1,) * (p.dim() - 1)

    def project(view):
        pv = _views(p)[view]
        p_n = p / (torch.linalg.vector_norm(pv, dim=1).reshape(expand) + eps)
        comp = _views(p_n * perturb)[view].sum(dim=1).reshape(expand)
        return perturb - p_n * comp

    gch, gla = _views(grad)
    pch, pla = _views(p)
    ch_hit = _cosine_max(gch, pch, eps) < delta / np.sqrt(pch.shape[1])
    la_hit = _cosine_max(gla, pla, eps) < delta / np.sqrt(pla.shape[1])
    out = torch.where(ch_hit, project(0),
                      torch.where(la_hit, project(1), perturb))
    wd = torch.where(ch_hit | la_hit, torch.tensor(wd_ratio, device=p.device),
                     torch.tensor(1.0, device=p.device))
    return out, wd


def adamp_step(keys, p, g, slots, count: int, lr: list[float],
               weight_decay: float, momentum: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, delta: float = 0.1,
               wd_ratio: float = 0.01, nesterov: bool = True
               ) -> list[torch.Tensor]:
    """`AdamP.step` (adamp.py:57-107) as the factory builds it (wd_ratio
    0.01, nesterov): the updates, moments advanced in place. `count` is the
    incremented step count, `lr` each leaf's rate at it."""
    bc1, bc2 = bias_correction(b1, count), bias_correction(b2, count)
    out = []
    for k, pi, gi, lri in zip(keys, p, g, lr):
        m, v = slots["mu"][k], slots["nu"][k]
        m.mul_(b1).add_(gi * (1 - b1))
        v.mul_(b2).add_(gi * gi * (1 - b2))
        denom = torch.sqrt(v) / float(np.sqrt(np.float32(bc2))) + eps
        perturb = ((b1 * m + (1 - b1) * gi) / denom if nesterov
                   else m / denom)
        perturb, wdr = _projection(pi, gi, perturb, delta, wd_ratio, eps)
        upd = -(lri / bc1) * perturb
        if weight_decay > 0:
            upd = upd - lri * weight_decay * wdr * pi
        out.append(upd)
    return out


def sgdp_step(keys, p, g, slots, count: int, lr: list[float],
              weight_decay: float, momentum: float, dampening: float = 0.0,
              nesterov: bool = True, eps: float = 1e-8, delta: float = 0.1,
              wd_ratio: float = 0.1) -> list[torch.Tensor]:
    """`SGDP.step` (sgdp.py:55-90), nesterov as the factory builds it."""
    out = []
    for k, pi, gi, lri in zip(keys, p, g, lr):
        buf = slots["trace"][k]
        buf.mul_(momentum).add_(gi * (1 - dampening))
        d_p = gi + momentum * buf if nesterov else buf.clone()
        d_p, wdr = _projection(pi, gi, d_p, delta, wd_ratio, eps)
        upd = -lri * d_p
        if weight_decay != 0:
            # p.mul_(1 - lr*wd*ratio/(1-momentum)), sgdp.py:79-80
            upd = upd - lri * weight_decay * wdr / (1 - momentum) * pi
        out.append(upd)
    return out


def rmsprop_tf_step(keys, p, g, slots, count: int, lr: list[float],
                    weight_decay: float, momentum: float, alpha: float = 0.9,
                    eps: float = 1e-10) -> list[torch.Tensor]:
    """`RMSpropTF.step` (rmsprop_tf.py:81-134) as the factory builds it
    (alpha 0.9, coupled decay, not centered, lr in the momentum)."""
    out = []
    for k, pi, gi, lri in zip(keys, p, g, lr):
        if weight_decay != 0:
            gi = gi + weight_decay * pi
        sa = slots["square_avg"][k]
        sa.add_((gi * gi - sa) * (1 - alpha))
        avg = torch.sqrt(sa + eps)
        if momentum > 0:
            buf = slots["momentum_buffer"][k]
            buf.mul_(momentum).add_(lri * gi / avg)
            out.append(-buf)
        else:
            out.append(-lri * gi / avg)
    return out


# ------------------------------------------------------------- AdaHessian

def rademacher_like(generator: torch.Generator,
                    tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """One +-1 probe per leaf, in the leaf's dtype, from `generator` (on
    the leaves' device), leaves in dict order."""
    return {k: (torch.randint(0, 2, t.shape, generator=generator,
                              device=t.device) * 2 - 1).to(t.dtype)
            for k, t in tree.items()}


def hutchinson(loss_fn: Callable, trainable: dict[str, torch.Tensor],
               generator: Optional[torch.Generator], *args,
               z: Optional[dict[str, torch.Tensor]] = None):
    """(loss, grads, hess): `loss_fn(trainable, *args)` once, its gradients
    with a graph, then H @ z from a second backward of <grads, z>, and the
    Hutchinson diagonal z * (H @ z) (adahessian.py:95-102). `z` defaults to
    `rademacher_like(generator, trainable)`. Leaves the loss does not reach
    get zero gradients and zero diagonals."""
    if z is None:
        z = rademacher_like(generator, trainable)
    keys = list(trainable)
    leaves = [trainable[k] for k in keys]
    loss = loss_fn(trainable, *args)
    grads = torch.autograd.grad(loss, leaves, create_graph=True,
                                allow_unused=True)
    live = [i for i, gi in enumerate(grads)
            if gi is not None and gi.requires_grad]
    hvp = [None] * len(keys)
    if live:
        got = torch.autograd.grad([grads[i] for i in live], leaves,
                                  grad_outputs=[z[keys[i]] for i in live],
                                  allow_unused=True)
        hvp = list(got)
    out_g, out_h = {}, {}
    for k, t, gi, hi in zip(keys, leaves, grads, hvp):
        out_g[k] = torch.zeros_like(t) if gi is None else gi.detach()
        out_h[k] = (torch.zeros_like(t) if hi is None
                    else z[k] * hi.detach())
    return loss.detach(), out_g, out_h


class AdaHessian:
    """`Adahessian.step` (adahessian.py:106-156) over the two groups (the
    JAX package's `adahessian_two_group`):

      g <- g * min(1, max_grad_norm / max(||g||, 1e-12))   (grads only)
      m = b1*m + (1-b1)*g;   v = b2*v + (1-b2)*hess^2
      p += -(lr / (1 - b1^t)) * m / ((v / (1 - b2^t))^(k/2) + eps)
           - lr * wd * p                          (where `decay[name]`)

    the learning rate of each group's schedule at the count before the
    step. `step(params, (grads, hess), state)`."""

    def __init__(self, schedules: dict[str, Schedule], groups: dict[str, str],
                 decay: dict[str, bool], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 hessian_power: float = 1.0, max_grad_norm: float = 0.0):
        self.schedules, self.groups, self.decay = schedules, groups, decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.hessian_power = weight_decay, hessian_power
        self.max_grad_norm = max_grad_norm

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        return OptState(0, {"exp_avg": {k: torch.zeros_like(p)
                                        for k, p in params.items()},
                            "exp_hess_sq": {k: torch.zeros_like(p)
                                            for k, p in params.items()}})

    @torch.no_grad()
    def clip_grads(self, grads: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """The gradients scaled by min(1, max_grad_norm / ||g||) over all
        of them (a new dict; the same dict when clipping is off)."""
        if self.max_grad_norm <= 0.0:
            return grads
        keys = list(grads)
        g = [grads[k] for k in keys]
        gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.clamp(self.max_grad_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        return dict(zip(keys, torch._foreach_mul(g, scale)))

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], pair,
             state: OptState, clipped: bool = False) -> None:
        """`clipped`: the gradients were already clipped over the whole
        trainable set (`clip_grads`; ZeRO hands each rank its own
        leaves)."""
        grads, hess = pair
        keys = list(params)
        if not clipped:
            grads = self.clip_grads({k: grads[k] for k in keys})
        g = [grads[k] for k in keys]
        lrs = {n: float(fn(state.count)) for n, fn in self.schedules.items()}
        state.count += 1
        bc1 = bias_correction(self.b1, state.count)
        bc2 = bias_correction(self.b2, state.count)
        m = [state.slots["exp_avg"][k] for k in keys]
        v = [state.slots["exp_hess_sq"][k] for k in keys]
        h = [hess[k] for k in keys]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(h, h),
                                                  1 - self.b2))
        for k, mi, vi in zip(keys, m, v):
            lr = lrs[self.groups[k]]
            denom = (vi / bc2) ** (self.hessian_power / 2.0) + self.eps
            upd = -(lr / bc1) * mi / denom
            if self.weight_decay != 0.0 and self.decay[k]:
                upd = upd - lr * self.weight_decay * params[k]
            params[k].add_(upd)


# ---------------------------------------------------------- plateau LR

@dataclasses.dataclass
class DynamicScaleState:
    scale: float = 1.0


class DynamicScale:
    """Multiply updates by a scale held in the optimizer's state (1.0 at
    init): the carrier of a host-driven rate factor (`PlateauLR.scale`),
    set with `set_dynamic_scale`."""

    def init(self, params=None) -> DynamicScaleState:
        return DynamicScaleState()

    def update(self, updates: dict[str, torch.Tensor],
               state: DynamicScaleState) -> dict[str, torch.Tensor]:
        return {k: u * state.scale for k, u in updates.items()}


def dynamic_scale() -> DynamicScale:
    return DynamicScale()


def set_dynamic_scale(opt_state, value: float):
    """`opt_state` with every `DynamicScaleState` in it (through tuples,
    lists and dicts) set to `value`; other leaves kept."""
    if isinstance(opt_state, DynamicScaleState):
        return DynamicScaleState(float(value))
    if isinstance(opt_state, tuple):
        return type(opt_state)(set_dynamic_scale(s, value) for s in opt_state)
    if isinstance(opt_state, list):
        return [set_dynamic_scale(s, value) for s in opt_state]
    if isinstance(opt_state, dict):
        return {k: set_dynamic_scale(s, value) for k, s in opt_state.items()}
    return opt_state


class PlateauLR:
    """torch `ReduceLROnPlateau`'s decisions (the engine of
    `mPLUG/scheduler/plateau_lr.py`) as a host-side controller: feed the
    eval metric once an epoch, read `.scale` (the cumulative factor,
    starting at 1.0). mode 'max' is the factory's default for eval-metric
    schedules."""

    def __init__(self, decay_rate: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, cooldown: int = 0,
                 mode: str = "max", min_scale: float = 0.0):
        self.factor = decay_rate
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.mode = mode
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_left = 0
        self.scale = 1.0

    def _better(self, metric: float) -> bool:
        """torch's relative threshold: max -> a > best * (1 + th), min ->
        a < best * (1 - th)."""
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """The (possibly decayed) cumulative scale, in torch's order: the
        best and bad-epoch count, then the cooldown, then the patience."""
        if self._better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.cooldown_left = self.cooldown
            self.num_bad = 0
        return self.scale
