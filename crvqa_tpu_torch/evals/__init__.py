"""Offline scorers and mask comparison (counterpart of
`crvqa_tpu/evals/`); host code only."""
from .scoring import (
    cal_metric,
    compute_vqacp_scores,
    compute_vqavs_scores,
    score_prediction_file,
    VQAVS_SPLITS,
)
from .vqa_eval import VQAEval, normalize_answer
from .compare_mask import compare_mask_dicts, compare_mask_files

__all__ = [
    "cal_metric", "compute_vqacp_scores", "compute_vqavs_scores",
    "score_prediction_file", "VQAVS_SPLITS",
    "VQAEval", "normalize_answer",
    "compare_mask_dicts", "compare_mask_files",
]
