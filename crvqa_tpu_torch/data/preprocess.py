"""Build the answer-target caches from raw VQA annotations (counterpart of
`crvqa_tpu/data/preprocess.py`; host code only).

The reference consumes prebuilt pickles (`cache/<split>_target.pkl`,
`train_test_ans2label.pkl`, `<split>_target_count.pth` — dataset_LXM.py,
comput_score.py) produced by an external SSL-VQA-style preprocessing step it
does not ship. This module makes the framework self-contained: from official
VQA question/annotation JSONs it derives the answer vocabulary (answers with
>= min_occurrence normalized occurrences), per-question soft targets
(min(#humans/3, 1) per answer), and the scorer-side annotation records.
"""
from __future__ import annotations

import json
import os
import pickle
from collections import Counter
from typing import Optional, Sequence

import torch

from ..evals.vqa_eval import normalize_answer


def build_answer_vocab(annotation_files: Sequence[str],
                       min_occurrence: int = 9) -> tuple[dict, list]:
    """ans2label / label2ans from answers appearing >= min_occurrence times
    (the standard VQA vocabulary rule behind train_test_ans2label.pkl)."""
    counts: Counter = Counter()
    for path in annotation_files:
        with open(path) as f:
            payload = json.load(f)
        annos = payload["annotations"] if isinstance(payload, dict) else payload
        for a in annos:
            for ans in a["answers"]:
                counts[normalize_answer(ans["answer"])] += 1
    label2ans = [a for a, c in counts.items() if c >= min_occurrence]
    label2ans.sort()
    ans2label = {a: i for i, a in enumerate(label2ans)}
    return ans2label, label2ans


def _soft_score(count: int) -> float:
    return min(1.0, count / 3.0)


def build_targets(annotation_file: str, ans2label: dict) -> list[dict]:
    """`<split>_target.pkl` records: {question_id, image_id, question_type,
    labels, scores} with soft scores min(#matching-humans/3, 1)."""
    with open(annotation_file) as f:
        payload = json.load(f)
    annos = payload["annotations"] if isinstance(payload, dict) else payload
    targets = []
    for a in annos:
        answer_count = Counter(
            normalize_answer(ans["answer"]) for ans in a["answers"])
        labels, scores = [], []
        for ans, c in answer_count.items():
            if ans in ans2label:
                labels.append(ans2label[ans])
                scores.append(_soft_score(c))
        targets.append({
            "question_id": a["question_id"],
            "image_id": a["image_id"],
            "question_type": a.get("question_type", ""),
            "labels": labels,
            "scores": scores,
        })
    return targets


def build_target_counts(annotation_file: str) -> list[dict]:
    """`<split>_target_count.pth` records consumed by the offline scorer
    (`comput_score.py:20-26`): {question_id, answers_word, answer_count,
    answer_type}."""
    with open(annotation_file) as f:
        payload = json.load(f)
    annos = payload["annotations"] if isinstance(payload, dict) else payload
    out = []
    for a in annos:
        answer_count = Counter(
            normalize_answer(ans["answer"]) for ans in a["answers"])
        out.append({
            "question_id": a["question_id"],
            "answers_word": list(answer_count.keys()),
            "answer_count": dict(answer_count),
            "answer_type": a.get("answer_type", ""),
        })
    return out


def build_cache(dataroot: str, train_anno: str, test_anno: str,
                min_occurrence: int = 9) -> dict:
    """Write the full cache layout the data pipeline expects under
    <dataroot>/cache/."""
    cache = os.path.join(dataroot, "cache")
    os.makedirs(cache, exist_ok=True)
    ans2label, label2ans = build_answer_vocab([train_anno, test_anno],
                                              min_occurrence)
    with open(os.path.join(cache, "train_test_ans2label.pkl"), "wb") as f:
        pickle.dump(ans2label, f)
    with open(os.path.join(cache, "train_test_label2ans.pkl"), "wb") as f:
        pickle.dump(label2ans, f)
    for split, anno in (("train", train_anno), ("test", test_anno)):
        with open(os.path.join(cache, f"{split}_target.pkl"), "wb") as f:
            pickle.dump(build_targets(anno, ans2label), f)
        torch.save(build_target_counts(anno),
                   os.path.join(cache, f"{split}_target_count.pth"))
    return {"ans_num": len(label2ans)}


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser("crvqa_tpu_torch.data.preprocess")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--train_anno", required=True,
                   help="raw VQA annotation JSON for the train split")
    p.add_argument("--test_anno", required=True)
    p.add_argument("--min_occurrence", type=int, default=9)
    args = p.parse_args(argv)
    info = build_cache(args.dataroot, args.train_anno, args.test_anno,
                       args.min_occurrence)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
