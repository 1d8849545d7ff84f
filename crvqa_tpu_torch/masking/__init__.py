"""Mask tables and pruning (counterpart of `crvqa_tpu/masking`)."""
from .spec import (LXMERT_WEIGHT_TYPES, VISUALBERT_ALL_WEIGHT_TYPES,
                   VISUALBERT_WEIGHT_TYPES, MaskSpec, lxmert_mask_specs,
                   visualbert_mask_specs)

__all__ = ["LXMERT_WEIGHT_TYPES", "VISUALBERT_ALL_WEIGHT_TYPES",
           "VISUALBERT_WEIGHT_TYPES", "MaskSpec", "lxmert_mask_specs",
           "visualbert_mask_specs"]
