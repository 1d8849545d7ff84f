"""Evaluation / prediction loop (counterpart of
`crvqa_tpu/train/evaluation.py`; `_prediction_loop` + `make_json`,
mask_trainer_Robust_VQA.py:487-496, 1096-1245): per-batch logits gathered
on the host, the VQA soft accuracy, and the `test.json` dump. Under a
data-parallel mesh each rank evaluates its block of every batch; the
logits are gathered over the data group (`host_all_gather`) and the host
fields over the control group (`host_all_gather_local`), so every rank
sees the whole prediction set (the reference's `distributed_concat`) and
rank 0 writes it."""
from __future__ import annotations

import json
from typing import Callable, Iterable, Sequence

import numpy as np

from ..parallel.mesh import (host_all_gather, host_all_gather_local,
                             is_main_process)
from ..utils.profiling import span


def predict(eval_step: Callable, state, batches: Iterable[dict],
            mesh=None) -> dict:
    """Run `eval_step(state, batch)` over `batches`; returns logits,
    question ids and labels on the host, with the rows a batch's `valid`
    vector marks as padding dropped. With a `mesh`, `batches` are this
    rank's blocks and every rank must iterate the same number of them (the
    gathers are collectives). Spans: each batch's `eval_step` and `fetch`
    (the gathers and copies to the host), identified by its index."""
    all_logits, all_qids, all_labels = [], [], []
    n_valid = 0
    for i, batch in enumerate(batches):
        with span("eval_step", i):
            logits = eval_step(state, batch)
        with span("fetch", i):
            logits = host_all_gather(logits.float(), mesh)
            valid = (host_all_gather_local(np.asarray(batch["valid"]), mesh)
                     if "valid" in batch else np.ones(logits.shape[0], bool))
            all_logits.append(logits[valid])
            if "question_id" in batch:
                all_qids.append(host_all_gather_local(
                    np.asarray(batch["question_id"]), mesh)[valid])
            if "labels" in batch:
                labels = batch["labels"]
                labels = (labels.cpu().numpy() if hasattr(labels, "cpu")
                          else np.asarray(labels))
                all_labels.append(host_all_gather_local(labels, mesh)[valid])
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
    """`test.json`; written by rank 0 only."""
    if not is_main_process():
        return
    with open(path, "w") as f:
        json.dump(make_json(logits, qids, label2ans), f)
