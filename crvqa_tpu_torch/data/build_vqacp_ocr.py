"""Build the VQA-CP v2 OCR/object annotation files the mPLUG pipeline trains
on (the port's own copy of `crvqa_tpu/data/build_vqacp_ocr.py`, host only,
numpy; its output files are byte for byte the JAX module's). A functional
port of `mPLUG/data/build_vqacp_ocr.py`: the reference is a run-once
script with hard-coded paths and unseeded random sampling; here every step
is a pure function and the val-split sample takes an explicit seed
(numpy's `default_rng(seed).choice`, as the JAX package draws it).

    crvqa-build-vqacp-ocr-torch --vqa_ocr_files ocr.json \
        --vqa_annotation_files v2_train_anns.json v2_val_anns.json \
        --vqacp_train_questions cp_train_q.json \
        --vqacp_test_questions cp_test_q.json --output_dir out

Inputs:
- VQA-v2 annotation JSONs ({"annotations": [{question_id, question_type,
  answer_type, ...}]}) for train+val — question/answer types per qid.
- vqa_ocr JSONs ([{question_id, image, question, answer: [str], ocr?,
  object_label?}, ...]) — the OCR-augmented VQA data.
- VQA-CP v2 question JSONs ([{question_id, ...}]) — the train/test split ids.

Outputs (build_all): train / test / val / train_bias entry lists plus
val/test label dicts in the reference's format.
"""
from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict
from typing import Sequence

import numpy as np


def load_type_maps(vqa_annotation_files: Sequence[str]
                   ) -> tuple[dict, dict]:
    """qid -> question_type / answer_type from the official VQA-v2
    annotations (build_vqacp_ocr.py:18-24)."""
    qtypes: dict = {}
    atypes: dict = {}
    for path in vqa_annotation_files:
        with open(path) as fh:
            anns = json.load(fh)["annotations"]
        for d in anns:
            qtypes[d["question_id"]] = d["question_type"]
            atypes[d["question_id"]] = d["answer_type"]
    return qtypes, atypes


def split_by_vqacp(ocr_records: Sequence[dict], train_ids: Sequence[int],
                   test_ids: Sequence[int], val_size: int = 20000,
                   seed: int = 0) -> dict[str, list]:
    """Partition the OCR data along the VQA-CP split and sample a val set
    from test (build_vqacp_ocr.py:35-40; the reference's random.sample is
    unseeded — we take a seed for reproducibility)."""
    by_qid = {d["question_id"]: d for d in ocr_records}
    out = {
        "train": [by_qid[i] for i in train_ids if i in by_qid],
        "test": [by_qid[i] for i in test_ids if i in by_qid],
    }
    rng = np.random.default_rng(seed)
    k = min(val_size, len(out["test"]))
    idx = rng.choice(len(out["test"]), size=k, replace=False)
    out["val"] = [out["test"][i] for i in idx]
    return out


def compute_train_bias(train_records: Sequence[dict], qtypes: dict
                       ) -> list[dict]:
    """Per-question-type answer probability attached as a per-answer `bias`
    list (build_vqacp_ocr.py:43-58) — the prior the (1-bias) debias loss
    consumes."""
    counts: dict = defaultdict(Counter)
    for d in train_records:
        qtype = qtypes[d["question_id"]]
        for answer in set(d["answer"]):
            counts[qtype][answer] += d["answer"].count(answer)
    probs = {qt: {a: c / sum(counter.values())
                  for a, c in counter.items()}
             for qt, counter in counts.items()}
    out = []
    for d in train_records:
        qtype = qtypes[d["question_id"]]
        new_d = dict(d)
        new_d["bias"] = [probs[qtype][a] for a in d["answer"]]
        out.append(new_d)
    return out


def build_label_file(records: Sequence[dict], qtypes: dict, atypes: dict
                     ) -> list[dict]:
    """Official-scorer label entries: min(count/3, 1) soft scores
    (build_vqacp_ocr.py:61-76)."""
    labels = []
    for d in records:
        qid = d["question_id"]
        img_id = (d["image"].replace("val2014_img/", "")
                  .replace("train2014/", "").replace(".jpg", ""))
        labels.append({
            "answer_type": atypes[qid],
            "img_id": img_id,
            "label": {a: min(d["answer"].count(a) / 3, 1)
                      for a in d["answer"]},
            "question_id": qid,
            "question_type": qtypes[qid],
            "sent": d["question"],
        })
    return labels


def build_all(ocr_records: Sequence[dict], train_ids: Sequence[int],
              test_ids: Sequence[int], qtypes: dict, atypes: dict,
              val_size: int = 20000, seed: int = 0) -> dict[str, list]:
    splits = split_by_vqacp(ocr_records, train_ids, test_ids, val_size, seed)
    splits["train_bias"] = compute_train_bias(splits["train"], qtypes)
    splits["test_label"] = build_label_file(splits["test"], qtypes, atypes)
    splits["val_label"] = build_label_file(splits["val"], qtypes, atypes)
    return splits


def main(argv=None) -> None:
    p = argparse.ArgumentParser("build_vqacp_ocr")
    p.add_argument("--vqa_ocr_files", nargs="+", required=True)
    p.add_argument("--vqa_annotation_files", nargs="+", required=True)
    p.add_argument("--vqacp_train_questions", required=True)
    p.add_argument("--vqacp_test_questions", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--val_size", type=int, default=20000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    records = []
    for f in args.vqa_ocr_files:
        with open(f) as fh:
            records.extend(json.load(fh))
    with open(args.vqacp_train_questions) as fh:
        train_ids = [d["question_id"] for d in json.load(fh)]
    with open(args.vqacp_test_questions) as fh:
        test_ids = [d["question_id"] for d in json.load(fh)]
    qtypes, atypes = load_type_maps(args.vqa_annotation_files)
    splits = build_all(records, train_ids, test_ids, qtypes, atypes,
                       args.val_size, args.seed)
    for name in ("train", "test", "val", "train_bias"):
        with open(os.path.join(args.output_dir, f"{name}.json"), "w") as fh:
            json.dump(splits[name], fh)
    for name in ("test", "val"):
        # reference filename: {split}_labels.json (build_vqacp_ocr.py:81;
        # the yaml's val_label_file/test_label_file point at these)
        with open(os.path.join(args.output_dir,
                               f"{name}_labels.json"), "w") as fh:
            json.dump(splits[f"{name}_label"], fh)
    print(json.dumps({k: len(v) for k, v in splits.items()}))


if __name__ == "__main__":
    main()
