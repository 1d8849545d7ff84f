"""Mask tables and pruning (counterpart of `crvqa_tpu/masking`)."""
from .spec import (LXMERT_WEIGHT_TYPES, VISUALBERT_ALL_WEIGHT_TYPES,
                   VISUALBERT_WEIGHT_TYPES, MaskSpec, lxmert_mask_specs,
                   visualbert_mask_specs)
from .structured import (StructuredMasker, binarize_ffn_ste,
                         binarize_head_ste, expand_head_mask_to_kernel,
                         magnitude_head_scores)

__all__ = ["LXMERT_WEIGHT_TYPES", "VISUALBERT_ALL_WEIGHT_TYPES",
           "VISUALBERT_WEIGHT_TYPES", "MaskSpec", "StructuredMasker",
           "binarize_ffn_ste", "binarize_head_ste",
           "expand_head_mask_to_kernel", "lxmert_mask_specs",
           "magnitude_head_scores", "visualbert_mask_specs"]
