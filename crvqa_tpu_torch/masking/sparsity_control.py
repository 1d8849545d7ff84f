"""Target-sparsity schedules and per-modality zero rates (the port's copy
of `crvqa_tpu/masking/sparsity_control.py`, the reference's
`masking/sparsity_control_Robust.py` and `HPmodel_modal`,
`prune_debias_VQA.py:369-387`): plain Python, no tensors.

Stage 2 pins its zero rates from the start; mPLUG mask training polls
`MaskerScheduler.step` every `--masker_update_step` steps at the fractional
epoch and resets every threshold to the target it returns
(`mPLUG/vqa_mplug.py:206-212`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


def automated_gradual_sparsity(
    init_sparsity: float,
    final_sparsity: float,
    interval_epoch: float,
    init_epoch: float,
    final_epoch: float,
) -> Callable[[float, float], float]:
    """Zhu & Gupta cubic schedule (sparsity_control_Robust.py:10-39)."""

    def f(current_epoch: float, current_sparsity: float) -> float:
        if current_epoch > final_epoch:
            return final_sparsity
        span = final_epoch - init_epoch
        if span != 0:
            return final_sparsity + (init_sparsity - final_sparsity) * (
                1.0 - (current_epoch - init_epoch) / span
            ) ** 3
        return final_sparsity

    return f


def stepwise_sparsity(
    init_sparsity: float,
    final_sparsity: float,
    interval_epoch: float,
    init_epoch: float,
    final_epoch: float,
    sparsity_incremental_ratio: float,
    with_safety_check: bool = True,
) -> Callable[[float, float], float]:
    """Stepwise scheme (sparsity_control_Robust.py:42-85)."""

    def _intervals(epoch: float) -> int:
        # number of boundary polls at or before `epoch`: the reference
        # increments AT each boundary incl. init_epoch itself
        # ((current_epoch - init_epoch) % interval <= 1e-5 fires at the
        # FIRST poll, sparsity_control_Robust.py:53-58) — hence the +1.
        # +1e-9 absorbs float-modulo error for fractional intervals
        # (0.3 % 0.1 == 0.0999... would otherwise skip most scheduled
        # increments — the MaskerScheduler default interval is 0.1).
        return int((epoch - init_epoch) / interval_epoch + 1e-9) + 1

    def f(current_epoch: float, current_sparsity: float) -> float:
        if current_epoch < init_epoch:
            return init_sparsity
        if current_epoch >= final_epoch:
            return final_sparsity
        # geometric approach toward 1: apply the increment once per
        # completed interval since the caller's last-seen sparsity. The
        # interval count makes the schedule a pure function of the epoch
        # (the reference's modulo trigger relies on being polled exactly
        # on the boundary, sparsity_control_Robust.py:42-85).
        n = _intervals(current_epoch)
        s = init_sparsity
        for _ in range(n):
            s = s + (1 - s) * sparsity_incremental_ratio
        return max(s, current_sparsity)

    if with_safety_check:
        reachable = f(final_epoch - 1e-9, init_sparsity)
        reachable += (1 - reachable) * sparsity_incremental_ratio
        if reachable < final_sparsity:
            raise ValueError(
                "Increase initial sparsity and/or incremental ratio; "
                f"reachable final sparsity {reachable} < required "
                f"{final_sparsity}")
    return f


@dataclasses.dataclass
class MaskerScheduler:
    """Epoch-indexed target-sparsity scheduler (sparsity_control_Robust.py:88-241).

    `step(cur_epoch)` returns `(incremental_sparsity, target_sparsity, changed)`.
    With `lambdas_lr == 0` (the shipped default) `is_skip` is True and the
    caller should pin sparsity at `init_sparsity` (== final_sparsity).
    """

    final_sparsity: float
    num_epochs: float = 20.0
    init_sparsity: Optional[float] = None
    sparsity_warmup: str = "automated_gradual_sparsity"
    sparsity_warmup_interval_epoch: float = 0.1
    init_epoch: Optional[float] = None
    final_epoch: Optional[float] = None
    lambdas_lr: float = 0.0
    sparsity_incremental_ratio: Optional[float] = None

    def __post_init__(self):
        if self.init_sparsity is None:
            self.init_sparsity = self.final_sparsity
        if self.init_epoch is None:
            self.init_epoch = int(self.num_epochs * 0.1)
        if self.final_epoch is None:
            self.final_epoch = int(self.num_epochs * 0.8)
        self._current_sparsity = 0.0
        if self.sparsity_warmup == "automated_gradual_sparsity":
            self.get_sparsity_fn = automated_gradual_sparsity(
                self.init_sparsity, self.final_sparsity,
                self.sparsity_warmup_interval_epoch,
                self.init_epoch, self.final_epoch,
            )
        elif self.sparsity_warmup == "stepwise_sparsity":
            assert self.sparsity_incremental_ratio is not None
            self.get_sparsity_fn = stepwise_sparsity(
                self.init_sparsity, self.final_sparsity,
                self.sparsity_warmup_interval_epoch,
                self.init_epoch, self.final_epoch,
                self.sparsity_incremental_ratio,
            )
        else:
            raise NotImplementedError(self.sparsity_warmup)
        self.target_sparsity = self.init_sparsity

    @property
    def is_skip(self) -> bool:
        return self.lambdas_lr == 0

    def step(self, cur_epoch: float) -> tuple[float, float, bool]:
        target = self.get_sparsity_fn(cur_epoch, self._current_sparsity)
        lo = min(self.init_sparsity, self.final_sparsity)
        hi = max(self.init_sparsity, self.final_sparsity)
        self.target_sparsity = min(hi, max(target, lo))
        incremental = (self.target_sparsity - self._current_sparsity) / (
            1 - self._current_sparsity
        )
        changed = self._current_sparsity != self.target_sparsity
        if changed:
            self._current_sparsity = self.target_sparsity
        return incremental, self.target_sparsity, changed

    def is_meet_sparsity(self) -> bool:
        return self.target_sparsity >= self.final_sparsity



@dataclasses.dataclass(frozen=True)
class ModalSparsity:
    """The entry scripts pass compression ratios (fraction KEPT) for
    Lang/Vis/Fus and the zero rate of the pooler: zero rates are
    {'Lang': 1 - Lang_comp, 'Vis': 1 - Vis_comp, 'Fus': 1 - Fus_comp,
    'P': zero_rate}."""

    zerorate: tuple[tuple[str, float], ...]

    @classmethod
    def from_compression(cls, lang_comp: float, vis_comp: float,
                         fus_comp: float, zero_rate: float) -> "ModalSparsity":
        return cls(zerorate=(("Lang", 1.0 - lang_comp),
                             ("Vis", 1.0 - vis_comp),
                             ("Fus", 1.0 - fus_comp),
                             ("P", zero_rate)))

    @classmethod
    def uniform(cls, zero_rate: float,
                modalities: tuple[str, ...] = ("Uni",)) -> "ModalSparsity":
        return cls(zerorate=tuple((m, zero_rate) for m in modalities))

    def as_dict(self) -> dict[str, float]:
        return dict(self.zerorate)

    def __getitem__(self, modality: str) -> float:
        return dict(self.zerorate)[modality]
