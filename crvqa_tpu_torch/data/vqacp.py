"""VQA-CP v2 data (counterpart of `crvqa_tpu/data/vqacp.py`): fixed-14
question tokenization, the answer vocabulary, training and test entries
with their per-question-type bias priors, the image-feature stores, and
fixed-shape batches.

File contract as the reference's (`dataset_LXM.py:118-179`):
  <dataroot>/vqacp_v2_<split>_questions.json
  <dataroot>/cache/<split>_target.pkl
  <dataroot>/cache/train_test_ans2label.pkl / train_test_label2ans.pkl
  image feature pickle {image_id: {'feats': [36, 2048], 'sp_feats': [36, 4]}}
  or the native `.bin` store (`native/feature_store.py`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from collections import Counter, defaultdict
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VQAEntries:
    """Column-oriented dataset: one row per question."""

    input_ids: np.ndarray  # [N, 14] int32
    lengths: np.ndarray  # [N] int32 (true token count before padding)
    image_ids: np.ndarray  # [N] str
    question_ids: np.ndarray  # [N] int64
    labels: np.ndarray  # [N, ans_num] float32 soft targets
    max_label: np.ndarray  # [N] int32 argmax answer (random if unlabeled)
    question_types: list  # [N] str
    bias: Optional[np.ndarray] = None  # [N, ans_num] float32

    def __len__(self) -> int:
        return len(self.question_ids)


def tokenize_questions(questions: Sequence[str], tokenizer,
                       max_length: int = 14
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-length-14 WordPiece ids padded with [PAD]
    (`VQAFeatureDataset.tokenize`, dataset_LXM.py:189-226: no [CLS]/[SEP],
    truncate-or-pad to 14), through the tokenizer's bulk `raw_ids_batch`
    (the native encoder for ASCII rows). Returns (ids [N, 14] int32,
    lengths [N])."""
    pad_id = tokenizer.convert_tokens_to_ids("[PAD]")
    ids = np.full((len(questions), max_length), pad_id, np.int32)
    lengths = np.zeros(len(questions), np.int32)
    for i, row in enumerate(tokenizer.raw_ids_batch(questions,
                                                    cap=max_length)):
        ids[i, : len(row)] = row
        lengths[i] = len(row)
    return ids, lengths


def load_answer_vocab(dataroot: str) -> tuple[dict, list]:
    with open(os.path.join(dataroot, "cache", "train_test_ans2label.pkl"), "rb") as f:
        ans2label = pickle.load(f)
    with open(os.path.join(dataroot, "cache", "train_test_label2ans.pkl"), "rb") as f:
        label2ans = pickle.load(f)
    return ans2label, label2ans


class ImageFeatures:
    """36-box Faster-RCNN features keyed by image id, from the reference's
    pickle (`vqa_img_feature_trainval.pickle`)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = pickle.load(f)

    def lookup(self, image_ids: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        feats = np.stack([
            np.asarray(self._data[str(i)]["feats"], np.float32) for i in image_ids])
        pos = np.stack([
            np.asarray(self._data[str(i)]["sp_feats"], np.float32) for i in image_ids])
        return feats, pos

    def ids(self) -> list:
        return list(self._data.keys())

    def __contains__(self, image_id: str) -> bool:
        return str(image_id) in self._data


def open_image_features(path: str):
    """The native mmap store for `.bin` paths, the pickle otherwise."""
    if path.endswith(".bin"):
        from ..native.feature_store import FeatureStore

        return FeatureStore(path)
    return ImageFeatures(path)


def make_tokenizer(vocab_path: Optional[str]):
    """BERT WordPiece tokenizer over a vocab file (LXMERT's vocab is
    bert-base-uncased's). The port carries no hub download: the file is
    required."""
    if not vocab_path or not os.path.exists(vocab_path):
        raise FileNotFoundError(
            f"vocab file {vocab_path!r} not found: the port's tokenizer needs "
            "--vocab_file (bert-base-uncased vocab.txt)")
    from .tokenization import WordPieceTokenizer

    return WordPieceTokenizer(vocab_file=vocab_path, do_lower_case=True)


def load_entries(dataroot: str, split: str, tokenizer, ans_num: int,
                 question_template: str = "vqacp_v2_%s_questions.json",
                 ratio: float = 1.0, seed: int = 0) -> VQAEntries:
    """`_load_dataset` + tokenize + tensorize (dataset_LXM.py:118-289):
    questions and targets sorted by question id, optionally subsampled to
    `ratio` with a seeded numpy choice."""
    with open(os.path.join(dataroot, question_template % split)) as f:
        questions = sorted(json.load(f), key=lambda x: x["question_id"])
    with open(os.path.join(dataroot, "cache", f"{split}_target.pkl"),
              "rb") as f:
        answers = sorted(pickle.load(f), key=lambda x: x["question_id"])[
            : len(questions)]
    if len(questions) != len(answers):
        raise ValueError(f"{split}: {len(questions)} questions but "
                         f"{len(answers)} targets")
    if ratio < 1.0:
        rng = np.random.RandomState(seed)
        idx = rng.choice(len(questions), int(len(questions) * ratio),
                         replace=False)
        questions = [questions[i] for i in idx]
        answers = [answers[i] for i in idx]
    return entries_from_qa(questions, answers, tokenizer, ans_num, seed)


def entries_from_qa(questions: Sequence[dict], answers: Sequence[dict],
                    tokenizer, ans_num: int, seed: int = 0) -> VQAEntries:
    """qid-aligned (question, target) records -> VQAEntries; an unlabeled
    question gets a random answer index (dataset_LXM.py:276)."""
    n = len(questions)
    input_ids, lengths = tokenize_questions(
        [q["question"] for q in questions], tokenizer)
    labels = np.zeros((n, ans_num), np.float32)
    max_label = np.zeros(n, np.int32)
    qtypes = []
    rng = np.random.RandomState(seed)
    for i, (q, a) in enumerate(zip(questions, answers)):
        if q["question_id"] != a["question_id"]:
            raise ValueError(f"question {q['question_id']} paired with "
                             f"target {a['question_id']}")
        qtypes.append(a.get("question_type", ""))
        lab = a.get("labels")
        if lab is not None and len(lab):
            lab = np.asarray(lab, np.int64)
            sco = np.asarray(a.get("scores"), np.float32)
            labels[i, lab] = sco
            max_label[i] = int(lab[int(np.argmax(sco))])
        else:
            max_label[i] = rng.randint(0, ans_num)
    return VQAEntries(
        input_ids=input_ids, lengths=lengths,
        image_ids=np.asarray([str(q["image_id"]) for q in questions]),
        question_ids=np.asarray([q["question_id"] for q in questions],
                                np.int64),
        labels=labels, max_label=max_label, question_types=qtypes)


def compute_bias_priors(train: VQAEntries, ans_num: int
                        ) -> dict[str, np.ndarray]:
    """Per question-type mean answer-score vector over the train set
    (prune_debias_VQA.py:884-911): the `bias` LMH, LPF and RUBI use."""
    totals: dict[str, np.ndarray] = defaultdict(
        lambda: np.zeros(ans_num, np.float32))
    counts: Counter = Counter()
    for i, q_type in enumerate(train.question_types):
        counts[q_type] += 1
        totals[q_type] += train.labels[i]
    return {t: totals[t] / c for t, c in counts.items()}


def attach_bias(entries: VQAEntries, priors: dict[str, np.ndarray],
                ans_num: int) -> None:
    bias = np.zeros((len(entries), ans_num), np.float32)
    for i, q_type in enumerate(entries.question_types):
        if q_type in priors:
            bias[i] = priors[q_type]
    entries.bias = bias


def iterate_batches(entries: VQAEntries, features, batch_size: int,
                    shuffle: bool = False, seed: int = 0,
                    drop_last: bool = False) -> Iterator[dict]:
    """Fixed-shape numpy batch dicts; a final ragged batch is padded with
    its last row and flagged in `valid` (or dropped with `drop_last`). The
    attention mask is all ones on purpose: the reference calls the model
    with no mask (mask_trainer_Robust_VQA.py:808), so [PAD] is attended."""
    n = len(entries)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start: start + batch_size]
        valid = np.ones(batch_size, bool)
        if len(idx) < batch_size:
            if drop_last:
                return
            pad = np.full(batch_size - len(idx), idx[-1])
            valid[len(idx):] = False
            idx = np.concatenate([idx, pad])
        feats, pos = features.lookup(entries.image_ids[idx])
        batch = {
            "input_ids": entries.input_ids[idx],
            "attention_mask": np.ones_like(entries.input_ids[idx],
                                           np.float32),
            "visual_feats": feats,
            "visual_pos": pos,
            "labels": entries.labels[idx],
            "max_label": entries.max_label[idx],
            "question_id": entries.question_ids[idx],
            "valid": valid,
        }
        if entries.bias is not None:
            batch["bias"] = entries.bias[idx]
        yield batch
