"""Evaluation / prediction loop (counterpart of
`crvqa_tpu/train/evaluation.py`; `_prediction_loop` + `make_json`,
mask_trainer_Robust_VQA.py:487-496, 1096-1245): per-batch logits gathered
on the host, the VQA soft accuracy, and the `test.json` dump."""
from __future__ import annotations

import json
from typing import Callable, Iterable, Sequence

import numpy as np


def predict(eval_step: Callable, state, batches: Iterable[dict]) -> dict:
    """Run `eval_step(state, batch)` over `batches`; returns logits,
    question ids and labels on the host, with the rows a batch's `valid`
    vector marks as padding dropped."""
    all_logits, all_qids, all_labels = [], [], []
    n_valid = 0
    for batch in batches:
        logits = np.asarray(eval_step(state, batch).float().cpu())
        valid = (np.asarray(batch["valid"]) if "valid" in batch
                 else np.ones(logits.shape[0], bool))
        all_logits.append(logits[valid])
        if "question_id" in batch:
            all_qids.append(np.asarray(batch["question_id"])[valid])
        if "labels" in batch:
            labels = batch["labels"]
            labels = (labels.cpu().numpy() if hasattr(labels, "cpu")
                      else np.asarray(labels))
            all_labels.append(labels[valid])
        n_valid += int(valid.sum())
    out = {"logits": (np.concatenate(all_logits) if all_logits
                      else np.zeros((0,)))}
    if all_qids:
        out["question_id"] = np.concatenate(all_qids)
    if all_labels:
        out["labels"] = np.concatenate(all_labels)
    out["num_examples"] = n_valid
    return out


def vqa_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """100 * mean soft score of the argmax answer."""
    idx = np.argmax(logits, axis=1)
    return float(100.0 * labels[np.arange(len(idx)), idx].sum() / len(idx))


def make_json(logits: np.ndarray, qids: Sequence, label2ans: Sequence[str]
              ) -> list[dict]:
    """[{question_id, answer}], the scorer's contract."""
    idx = np.argmax(logits, axis=1)
    return [{"question_id": int(q), "answer": str(label2ans[int(i)])}
            for q, i in zip(qids, idx)]


def dump_predictions(path: str, logits: np.ndarray, qids: Sequence,
                     label2ans: Sequence[str]) -> None:
    with open(path, "w") as f:
        json.dump(make_json(logits, qids, label2ans), f)
