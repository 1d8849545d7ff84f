"""Per-modality target zero rates (counterpart of the `ModalSparsity` of
`crvqa_tpu/masking/sparsity_control.py`, the reference's `HPmodel_modal`,
`prune_debias_VQA.py:369-387`). The mPLUG scheduler is not ported yet."""
from __future__ import annotations

import dataclasses


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
