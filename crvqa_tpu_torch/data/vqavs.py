"""VQA-VS data (counterpart of `crvqa_tpu/data/vqavs.py`, the reference's
`dataset_LXM_VQAvs.py`).

The VQA-CP pipeline with other file names: per-split question JSONs
(Training-Ques.json / Val-Ques.json / IID-Test-Ques.json), the split target
pickles, and a train_val_test answer vocabulary. Scoring goes through
`crvqa_tpu_torch.evals.compute_vqavs_scores` (9 OOD splits and
Final_Score).
"""
from __future__ import annotations

import json
import os
import pickle

from .vqacp import VQAEntries, entries_from_qa

VQAVS_QUESTION_FILES = {
    "train": "Training-Ques.json",
    "val": "Val-Ques.json",
    "test": "IID-Test-Ques.json",
}


def load_answer_vocab(dataroot: str) -> tuple[dict, list]:
    with open(os.path.join(dataroot, "cache", "train_val_test_ans2label.pkl"),
              "rb") as f:
        ans2label = pickle.load(f)
    with open(os.path.join(dataroot, "cache", "train_val_test_label2ans.pkl"),
              "rb") as f:
        label2ans = pickle.load(f)
    return ans2label, label2ans


def load_entries(dataroot: str, split: str, tokenizer, ans_num: int,
                 seed: int = 0) -> VQAEntries:
    """Questions and targets of `split`, both sorted by question id (the
    targets cut to the questions' count), through the VQA-CP loader's
    `entries_from_qa`."""
    if split not in VQAVS_QUESTION_FILES:
        raise ValueError(f"VQA-VS split {split!r}: one of "
                         f"{sorted(VQAVS_QUESTION_FILES)}")
    with open(os.path.join(dataroot, VQAVS_QUESTION_FILES[split])) as f:
        payload = json.load(f)
    questions = payload["questions"] if isinstance(payload, dict) else payload
    questions = sorted(questions, key=lambda x: x["question_id"])
    with open(os.path.join(dataroot, "cache", f"{split}_target.pkl"),
              "rb") as f:
        answers = sorted(pickle.load(f), key=lambda x: x["question_id"])[
            : len(questions)]
    if len(questions) != len(answers):
        raise ValueError(f"{split}: {len(questions)} questions but "
                         f"{len(answers)} targets")
    return entries_from_qa(questions, answers, tokenizer, ans_num, seed)
