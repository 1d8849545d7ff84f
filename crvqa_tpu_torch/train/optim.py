"""mPLUG's `--opt` table (counterpart of `crvqa_tpu/train/mplug_train.py:
287-348` `_inner_optimizer`): the reference's timm factory surface
(`mPLUG/optim/optim_factory.py:56-127`) as the JAX package builds it, over
two groups of a flat dict of tensors, updated in place.

The JAX package builds sgd / nesterov / momentum / adam / adamw /
fusedadam / fusedadamw / nadam / radam / adadelta / adafactor / rmsprop /
novograd / lamb / fusedlamb from optax, and this module holds optax's
arithmetic (optax 0.2.6), not `torch.optim`'s, where the two differ:
NAdam's look-ahead is optax's bias-corrected nesterov form (no momentum
decay schedule), RMSprop starts its square average at 0 with eps inside the
square root and the learning rate before the momentum trace, Adafactor
factors the second moment of every leaf with two dims of 128 or more,
clips by block RMS 1.0, decays at 1 - (t+1)^-0.8 and scales by the
parameter's RMS, and LAMB's trust ratio is ||p|| / ||u||, 1 where either
is 0. adamp / sgdp / rmsproptf are `timm_optim`'s. A `lookahead_` prefix
(or any `<x>_` prefix) is stripped, as the JAX factory strips it; the
Lookahead wrapper itself is not applied in either package.

Where the table has it, torch's coupled L2 (`add_decayed_weights(mask=
decay_mask)`) is added to the gradient BEFORE the transform; adamw and
lamb decay decoupled, on their own update. The caller clips by one global
norm over both groups first (`optax.clip_by_global_norm` before the
`multi_transform`). Each group's learning rate is its schedule at the
count before the step (`scale_by_schedule`); every group shares the
count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import Schedule, bias_correction

# the JAX table's names (mplug_train.py:303-340)
OPTAX_OPTS = ("sgd", "nesterov", "momentum", "adam", "adamw", "fusedadam",
              "fusedadamw", "nadam", "radam", "adadelta", "adafactor",
              "rmsprop", "novograd", "fusedlamb", "lamb")
TIMM_OPTS = ("adamp", "sgdp", "rmsproptf")
# optimizers whose decay is their own (no coupled L2 before them)
_OWN_DECAY = ("adamw", "fusedadamw", "lamb", "fusedlamb") + TIMM_OPTS


def base_name(opt: str) -> str:
    """The factory's name: lower case, any `<x>_` prefix dropped."""
    return opt.lower().split("_")[-1]


@dataclasses.dataclass
class OptState:
    """`count` steps taken; each slot a dict of tensors keyed like the
    parameters (only the leaves that have one)."""

    count: int
    slots: dict[str, dict[str, torch.Tensor]]


def _f32(x) -> np.float32:
    return np.float32(x)


class TwoGroupOptimizer:
    """One `--opt` of the table over two groups: `groups[name]` names each
    parameter's group, `schedules[group]` its learning rate, `decay[name]`
    whether weight decay applies to it (the coupled L2, or adamw's and
    lamb's decoupled decay; adamp / sgdp / rmsproptf decay every leaf, as
    the JAX table builds them). `momentum` is `--opt_momentum`."""

    def __init__(self, opt: str, schedules: dict[str, Schedule],
                 groups: dict[str, str], decay: dict[str, bool],
                 weight_decay: float = 0.0, momentum: float = 0.9):
        self.name = base_name(opt)
        if self.name not in OPTAX_OPTS + TIMM_OPTS:
            raise ValueError(
                f"unsupported opt '{opt}' "
                f"(one of {sorted(OPTAX_OPTS + TIMM_OPTS)} or adahessian)")
        self.schedules, self.groups, self.decay = schedules, groups, decay
        self.weight_decay, self.momentum = weight_decay, momentum

    # -------------------------------------------------------------- state

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        n = self.name
        if n in ("sgd", "nesterov", "momentum", "sgdp"):
            slots = {"trace": zeros()}
        elif n in ("adadelta",):
            slots = {"e_g": zeros(), "e_x": zeros()}
        elif n == "adafactor":
            slots = {"v_row": {}, "v_col": {}, "v": {}}
            for k, p in params.items():
                dims = _factored_dims(p.shape)
                if dims is None:
                    slots["v"][k] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    slots["v_row"][k] = torch.zeros_like(p.sum(dim=d0))
                    slots["v_col"][k] = torch.zeros_like(p.sum(dim=d1))
        elif n == "rmsprop":
            slots = {"nu": zeros(), "trace": zeros()}
        elif n == "novograd":
            slots = {"mu": zeros(),
                     "nu": {k: torch.zeros((), dtype=p.dtype, device=p.device)
                            for k, p in params.items()}}
        elif n == "rmsproptf":
            slots = {"square_avg": {k: torch.ones_like(p)
                                    for k, p in params.items()},
                     "momentum_buffer": zeros()}
        else:  # the Adam family, adamp
            slots = {"mu": zeros(), "nu": zeros()}
        return OptState(0, slots)

    # --------------------------------------------------------------- step

    def _lrs(self, count: int) -> dict[str, float]:
        return {g: float(fn(count)) for g, fn in self.schedules.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: OptState) -> None:
        """One update of `params` (in place) from the clipped `grads`;
        advances `state` in place."""
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        n = self.name
        if n in TIMM_OPTS:
            from . import timm_optim

            # timm's classes read the schedule at the incremented count
            lrs = self._lrs(state.count + 1)
            lr = [lrs[self.groups[k]] for k in keys]
            fn = {"adamp": timm_optim.adamp_step,
                  "sgdp": timm_optim.sgdp_step,
                  "rmsproptf": timm_optim.rmsprop_tf_step}[n]
            u = fn(keys, p, g, state.slots, state.count + 1, lr,
                   self.weight_decay, self.momentum)
        else:
            if self.weight_decay and n not in _OWN_DECAY:
                g = self._decayed(keys, g, p)
            u = self._direction(keys, p, g, state)
            if self.weight_decay and n in _OWN_DECAY:
                u = self._decayed(keys, u, p)
            if n in ("lamb", "fusedlamb"):
                u = _trust_ratio(p, u)
            lrs = self._lrs(state.count)
            u = self._scale_by_lr(keys, u, lrs)
            if n == "rmsprop":
                trace = [state.slots["trace"][k] for k in keys]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, u)
                u = trace
        torch._foreach_add_(p, u)
        state.count += 1

    def _decayed(self, keys, g, p) -> list[torch.Tensor]:
        """g + weight_decay * p where the decay mask is on."""
        return [gi + self.weight_decay * pi if self.decay[k] else gi
                for k, gi, pi in zip(keys, g, p)]

    def _scale_by_lr(self, keys, u, lrs) -> list[torch.Tensor]:
        """u * -lr of its group (adafactor's chain ends in scale(-1) after
        a positive learning rate and the parameter scale)."""
        out = list(u)
        for group, lr in lrs.items():
            idx = [i for i, k in enumerate(keys) if self.groups[k] == group]
            if idx:
                scaled = torch._foreach_mul([u[i] for i in idx], -lr)
                for i, t in zip(idx, scaled):
                    out[i] = t
        return out

    def _direction(self, keys, p, g, state: OptState) -> list[torch.Tensor]:
        """The transform between the coupled decay and the learning rate
        (scale_by_adam, trace, scale_by_rms, ...), slots updated in place."""
        n, slots = self.name, state.slots
        c1 = state.count + 1
        if n in ("sgd", "nesterov", "momentum"):
            trace = [slots["trace"][k] for k in keys]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            if n == "momentum":
                return list(trace)
            return torch._foreach_add(g, torch._foreach_mul(
                trace, self.momentum))
        if n == "adadelta":
            rho, eps = 0.9, 1e-6
            e_g = [slots["e_g"][k] for k in keys]
            e_x = [slots["e_x"][k] for k in keys]
            _ema_(e_g, torch._foreach_mul(g, g), rho)
            u = [torch.sqrt(x + eps) / torch.sqrt(eg + eps) * gi
                 for x, eg, gi in zip(e_x, e_g, g)]
            _ema_(e_x, torch._foreach_mul(u, u), rho)
            return u
        if n == "adafactor":
            return _adafactor(keys, p, g, slots, state.count)
        if n == "rmsprop":
            nu = [slots["nu"][k] for k in keys]
            _ema_(nu, torch._foreach_mul(g, g), 0.9)
            return [gi * torch.rsqrt(v + 1e-8) for gi, v in zip(g, nu)]
        if n == "novograd":
            return _novograd(keys, g, slots, c1)
        # the Adam family: scale_by_adam (lamb with eps 1e-6), radam, nadam
        b1, b2 = 0.9, 0.999
        eps = 1e-6 if n in ("lamb", "fusedlamb") else 1e-8
        mu = [slots["mu"][k] for k in keys]
        nu = [slots["nu"][k] for k in keys]
        _ema_(mu, g, b1)
        _ema_(nu, torch._foreach_mul(g, g), b2)
        nu_hat = torch._foreach_div(nu, bias_correction(b2, c1))
        if n == "nadam":
            mu_hat = torch._foreach_div(mu, bias_correction(b1, c1 + 1))
            torch._foreach_mul_(mu_hat, b1)
            g_hat = torch._foreach_div(g, bias_correction(b1, c1))
            torch._foreach_add_(mu_hat, torch._foreach_mul(g_hat, 1 - b1))
        else:
            mu_hat = torch._foreach_div(mu, bias_correction(b1, c1))
        if n == "radam":
            ro = _radam_ro(b2, c1)
            if ro < _f32(5.0):
                return mu_hat
            ro_inf = _f32(2.0 / (1.0 - b2) - 1.0)
            r = np.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * ro_inf
                        / ((ro_inf - _f32(4.0)) * (ro_inf - _f32(2.0))
                           * ro))
            torch._foreach_mul_(mu_hat, float(r))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        return torch._foreach_div(mu_hat, denom)


def _ema_(moments: list[torch.Tensor], x: list[torch.Tensor],
          decay: float) -> None:
    """moments <- (1 - decay) * x + decay * moments, in place
    (`tree_update_moment`)."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, torch._foreach_mul(x, 1 - decay))


def _radam_ro(b2: float, c1: int) -> np.float32:
    """RAdam's rho_t in float32, as optax forms it from an int32 count."""
    b2t = _f32(b2) ** _f32(c1)
    ro_inf = _f32(2.0 / (1.0 - b2) - 1.0)
    return ro_inf - _f32(2 * c1) * b2t / (_f32(1.0) - b2t)


def _trust_ratio(p, u) -> list[torch.Tensor]:
    """`scale_by_trust_ratio`: u * ||p|| / ||u||, 1 where either is 0."""
    pn = torch._foreach_norm(p)
    un = torch._foreach_norm(u)
    return [ui * torch.where((a == 0) | (b == 0), torch.ones_like(a), a / b)
            for ui, a, b in zip(u, pn, un)]


def _factored_dims(shape) -> tuple[int, int] | None:
    """optax's `_factored_dims` (factored, min_dim_size_to_factor 128):
    the two largest dims (second largest first) of a leaf with two or
    more dims whose second largest is 128 or more."""
    if len(shape) < 2:
        return None
    order = np.argsort(tuple(shape))
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor(keys, p, g, slots, count: int) -> list[torch.Tensor]:
    """optax.adafactor's chain up to its learning rate:
    scale_by_factored_rms (decay 1 - (t+1)^-0.8, eps 1e-30), then
    clip_by_block_rms(1.0), with the learning rate and
    scale_by_param_block_rms(1e-3) folded in by `_adafactor_lr`."""
    rate = float(_f32(1.0) - _f32(count + 1) ** _f32(-0.8))
    out = []
    for k, gi in zip(keys, g):
        dims = _factored_dims(gi.shape)
        sq = gi * gi + 1e-30
        if dims is not None:
            d1, d0 = dims
            v_row, v_col = slots["v_row"][k], slots["v_col"][k]
            v_row.mul_(rate).add_(sq.mean(dim=d0) * (1.0 - rate))
            v_col.mul_(rate).add_(sq.mean(dim=d1) * (1.0 - rate))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = gi * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = slots["v"][k]
            v.mul_(rate).add_(sq * (1.0 - rate))
            u = gi * v ** -0.5
        rms = torch.sqrt(torch.mean(u * u))
        out.append(u / torch.clamp(rms / 1.0, min=1.0))
    # scale_by_learning_rate(flip_sign=False) and scale_by_param_block_rms
    # come next; `_scale_by_lr` applies -lr (the final scale(-1) folded in)
    for i, pi in enumerate(p):
        rms = torch.sqrt(torch.mean(pi * pi))
        out[i] = out[i] * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3),
                                      rms)
    return out


def _novograd(keys, g, slots, c1: int) -> list[torch.Tensor]:
    """`scale_by_novograd(b1=0.9, b2=0.25, eps=1e-6)`: a per-leaf scalar
    second moment of ||g||^2, its first value taken as is."""
    b1, b2, eps = 0.9, 0.25, 1e-6
    out = []
    for k, gi in zip(keys, g):
        sq = torch.linalg.vector_norm(gi) ** 2
        nu, mu = slots["nu"][k], slots["mu"][k]
        if c1 == 1:
            nu.copy_(sq)
            mu.copy_(gi / (torch.sqrt(nu) + eps))
        else:
            nu.copy_((1 - b2) * sq + b2 * nu)
            mu.copy_(b1 * mu + gi / (torch.sqrt(nu) + eps))
        out.append(mu.clone())
    return out


def is_second_order(opt: str) -> bool:
    """adahessian needs Hessian-diagonal probes beside the gradients."""
    return base_name(opt) == "adahessian"
