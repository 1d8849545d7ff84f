"""Offline prediction scoring (counterpart of `crvqa_tpu/evals/scoring.py`),
output-compatible with the reference scorers.

`comput_score.py` (VQA-CP v2 accuracy with the yes-no / number / other
breakdown, also the VQA v2 scorer `V2_comput_score.py`) and
`comput_vqavs_score.py` (VQA-VS: the IID score, the 9 OOD splits and their
mean Final_Score). Same JSON / annotation inputs, same numbers out; torch
only reads the reference's pickled `<split>_target_count.pth` annotation
files. Host code only: no device.

    python -m crvqa_tpu_torch.evals.scoring --task vqavs \
        --input out/prefictions_VQAvs_test.json \
        --anno DATA/VQAvs_test_annotations.json
"""
from __future__ import annotations

import json
from typing import Optional, Sequence


def _min1(x: float) -> float:
    return min(1.0, x)


def compute_vqacp_scores(predictions: Sequence[dict],
                         annotations: Sequence[dict]) -> dict:
    """`comput_score.py:20-89` — official VQA soft accuracy with answer-type
    breakdown. `predictions`: [{question_id, answer}]; `annotations`:
    [{question_id, answers_word, answer_count, answer_type}].
    """
    annotations = sorted(annotations, key=lambda x: x["question_id"])
    # align BY question_id: the reference zips sorted lists positionally,
    # which silently desynchronizes every later pair after one missing or
    # duplicated prediction (last-write-wins here matches scorer intent)
    by_qid = {p["question_id"]: p for p in predictions}
    score = yes_no_score = num_score = other_score = 0.0
    upper = upper_yes = upper_num = upper_other = 0.0
    count = yes_count = num_count = other_count = 0
    matched = 0
    for anno in annotations:
        pred = by_qid.get(anno["question_id"])
        if pred is None:
            continue
        matched += 1
        gt = max(anno["answer_count"].values())
        upper += _min1(gt / 3)
        atype = anno["answer_type"]
        if atype == "yes/no":
            yes_count += 1
            upper_yes += _min1(gt / 3)
        elif atype == "number":
            num_count += 1
            upper_num += _min1(gt / 3)
        elif atype == "other":
            other_count += 1
            upper_other += _min1(gt / 3)
        if pred["answer"] in anno["answers_word"]:
            proba = anno["answer_count"][pred["answer"]]
            s = _min1(proba / 3)
            score += s
            count += 1
            if atype == "yes/no":
                yes_no_score += s
            elif atype == "number":
                num_score += s
            elif atype == "other":
                other_score += s
    n = len(annotations)
    return {
        "overall": round(score * 100 / n, 2) if n else 0.0,
        "yes/no": round(100 * yes_no_score / yes_count, 2) if yes_count else 0.0,
        "number": round(100 * num_score / num_count, 2) if num_count else 0.0,
        "other": round(100 * other_score / other_count, 2) if other_count else 0.0,
        "upper_bound": round(upper * 100 / n, 2) if n else 0.0,
        "count": count,
        "matched": matched,
    }


def _vqavs_get_score(annotations: Sequence[dict],
                     predictions: Sequence[dict]) -> float:
    """`comput_vqavs_score.py:get_scores` (:16-67) — soft accuracy over a
    split. The reference annotation contract carries `answers_word` +
    `answer_count` (vote counts); official-format `answers` lists of
    {'answer': str} dicts are accepted as a fallback. Per-split scores are
    ROUNDED to 2 decimals exactly like the reference (its Final_Score
    averages the rounded values)."""
    total = 0.0
    for anno, pred in zip(annotations, predictions):
        if "answers_word" in anno:  # the reference's own contract
            if pred["answer"] in anno["answers_word"]:
                total += _min1(anno["answer_count"][pred["answer"]] / 3)
            continue
        answers = [a["answer"] if isinstance(a, dict) else a
                   for a in anno["answers"]]
        matching = sum(1 for a in answers if a == pred["answer"])
        total += _min1(matching / 3)
    return round(100.0 * total / len(annotations), 2) if annotations else 0.0


VQAVS_SPLITS = ("QT", "KW", "KWP", "QTKW", "KO", "KOP", "QTKO", "KWKO", "QTKWKO")


def compute_vqavs_scores(predictions: Sequence[dict], test_anno: dict) -> dict:
    """`comput_vqavs_score.py` — IID score + 9 OOD splits + mean Final_Score.

    `test_anno` is the `VQAvs_test_annotations.json` payload:
    {'annotations': [...], '<split>_qid': [...] for the 9 OOD splits}.
    """
    annotations = sorted(test_anno["annotations"],
                         key=lambda x: x["question_id"])
    # qid-keyed pairing (NOT positional zip of two sorted lists — one
    # missing/duplicate qid would silently shift every later pair; same fix
    # as compute_vqacp_scores above). Identical numbers when lists align,
    # which the reference's own zip assumes.
    by_qid = {p["question_id"]: p for p in predictions}
    missing = [a["question_id"] for a in annotations
               if a["question_id"] not in by_qid]
    if missing:
        raise ValueError(
            f"{len(missing)} annotated qids lack predictions "
            f"(first: {missing[:3]})")
    predictions = [by_qid[a["question_id"]] for a in annotations]
    result = {"iid": _vqavs_get_score(annotations, predictions)}
    split_ids = {s: set(test_anno[f"{s}_qid"]) for s in VQAVS_SPLITS}
    per_split_anno = {s: [] for s in VQAVS_SPLITS}
    per_split_pred = {s: [] for s in VQAVS_SPLITS}
    for anno, pred in zip(annotations, predictions):
        qid = anno["question_id"]
        for s in VQAVS_SPLITS:
            if qid in split_ids[s]:
                per_split_anno[s].append(anno)
                per_split_pred[s].append(pred)
    for s in VQAVS_SPLITS:
        result[s] = _vqavs_get_score(per_split_anno[s], per_split_pred[s])
    result["Final_Score"] = sum(result[s] for s in VQAVS_SPLITS) / len(VQAVS_SPLITS)
    return result


def load_target_count_annotations(path: str) -> list[dict]:
    """Read the reference's `<split>_target_count.pth` (a torch pickle)."""
    import torch

    return torch.load(path, weights_only=False)


def score_prediction_file(pred_path: str, anno_path: str) -> dict:
    with open(pred_path) as f:
        predictions = json.load(f)
    annotations = load_target_count_annotations(anno_path)
    return compute_vqacp_scores(predictions, annotations)


def cal_metric(vqa_result: Sequence[dict], label_file: str) -> float:
    """mPLUG label-dict scoring (`mPLUG/vqa_mplug.py:289-303`): mean soft
    score of each predicted answer under {question_id: {answer: score}}."""
    with open(label_file) as f:
        data_list = json.load(f)
    id2label = {d["question_id"]: d["label"] for d in data_list}
    score = 0.0
    for each in vqa_result:
        label = id2label.get(each["question_id"], {})
        score += label.get(each["answer"], 0.0)
    return score / len(vqa_result) if vqa_result else 0.0


def _main(argv: Optional[Sequence[str]] = None) -> None:
    """Offline scorer CLI — `comput_score.py` / `comput_vqavs_score.py`
    equivalents over the same artifacts."""
    import argparse

    p = argparse.ArgumentParser("crvqa_tpu_torch.evals.scoring")
    p.add_argument("--input", required=True, help="prediction JSON")
    p.add_argument("--anno", required=True,
                   help="<split>_target_count.pth (vqacp/v2) or "
                        "VQAvs_test_annotations.json (vqavs) or label json (mplug)")
    p.add_argument("--task", default="vqacp", choices=["vqacp", "vqavs", "mplug"])
    args = p.parse_args(argv)
    with open(args.input) as f:
        preds = json.load(f)
    if args.task == "vqacp":
        print(json.dumps(compute_vqacp_scores(
            preds, load_target_count_annotations(args.anno))))
    elif args.task == "vqavs":
        with open(args.anno) as f:
            print(json.dumps(compute_vqavs_scores(preds, json.load(f))))
    else:
        print(json.dumps({"acc": cal_metric(preds, args.anno)}))


if __name__ == "__main__":
    _main()
