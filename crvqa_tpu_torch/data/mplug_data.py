"""mPLUG data (the port's copy of `crvqa_tpu/data/mplug_data.py`; the
reference's `mPLUG/dataset/vqa_dataset.py` and its collate functions): raw
images plus question / answer JSON records at fixed shapes. The ragged
per-question answer lists become a fixed `answers_per_question` slot
dimension with zero weights marking padding.

Fixed-length question and answer tokenization, the OCR / object question
splicing, annotation loading (`load_entries`), the batch iterator
(`iterate_batches`, eval transform only: the train-time augmentations are
not ported yet), the image loader and synthetic batches."""
from __future__ import annotations

import dataclasses
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class MPlugEntries:
    question_ids: np.ndarray  # [N] int64 (running index for eval)
    question_tokens: np.ndarray  # [N, Lq]
    question_mask: np.ndarray  # [N, Lq]
    answer_tokens: np.ndarray  # [N, A, La]
    answer_mask: np.ndarray  # [N, A, La]
    weights: np.ndarray  # [N, A]
    bias: np.ndarray  # [N, A]
    image_paths: list

    def __len__(self) -> int:
        return len(self.image_paths)


def _tokenize_fixed(tokenizer, texts: Sequence[str], max_len: int,
                    add_special: bool = True, extra_eos: bool = False
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(ids int32 [N, max_len], mask fp32 [N, max_len]). `extra_eos`: one
    more [SEP] after the row's end, the reference's `answer + eos` rows
    ending [SEP] [SEP] (vqa_dataset.py:107)."""
    enc = tokenizer(list(texts), padding="max_length", truncation=True,
                    max_length=max_len, add_special_tokens=add_special)
    ids = np.asarray(enc["input_ids"], np.int32)
    mask = np.asarray(enc["attention_mask"], np.float32)
    if extra_eos:
        sep = int(tokenizer.sep_token_id)
        for r in range(ids.shape[0]):
            end = int(mask[r].sum())
            if end < max_len:
                ids[r, end] = sep
                mask[r, end] = 1.0
    return ids, mask


def question_token_len(add_ocr: bool, max_input_length: int) -> int:
    """Question rows are max_input_length wide with OCR splicing, 25
    otherwise (`vqa_mplug.py:159,474`)."""
    return max_input_length if add_ocr else 25


def pre_question(question: str, max_ques_words: int) -> str:
    """Question normalisation (`pre_question`, mPLUG/dataset/utils.py:
    3-16): strip punctuation, lowercase, split dashes and slashes, cut to
    max words."""
    question = re.sub(r"([,.'!?\"()*#:;~])", "", question.lower())
    question = question.replace("-", " ").replace("/", " ").rstrip(" ")
    words = question.split(" ")
    if len(words) > max_ques_words:
        question = " ".join(words[:max_ques_words])
    return question


def augment_question(record: dict, add_ocr: bool, add_object: bool,
                     max_ques_words: int = 30) -> str:
    """OCR / object-label question splicing (vqa_dataset.py:57-70)."""
    question = record["question"]
    if add_ocr and "ocr" in record:
        tokens = [tok for _, tok in record["ocr"]]
        if tokens:
            question = (question + " [SEP] "
                        + pre_question(" ".join(tokens), max_ques_words))
    if add_object and "object_label" in record:
        question = (question + " [SEP] "
                    + " ".join(record["object_label"].split("&&")))
    return question


def load_entries(ann_files: Sequence[str], tokenizer, q_len: int = 25,
                 a_len: int = 12, answers_per_question: int = 10,
                 vqa_root: str = "", add_ocr: bool = False,
                 add_object: bool = False,
                 max_ques_words: int = 30) -> MPlugEntries:
    """Parse the reference's annotation JSONs (`vqa_dataset.__getitem__`,
    mPLUG/dataset/vqa_dataset.py:82-109): training records carry answer
    lists; each unique answer gets weight count / len(answers);
    `train_bias` records add one bias scalar per raw answer, carried
    through the dedup BY ANSWER (the first occurrence wins, :85-91).
    `add_ocr` / `add_object` splice OCR and object tokens into the question
    (:57-70)."""
    records = []
    for f in ann_files:
        with open(f) as fh:
            records.extend(json.load(fh))
    n, a_max = len(records), answers_per_question
    q_tokens, q_mask = _tokenize_fixed(
        tokenizer,
        [augment_question(r, add_ocr, add_object, max_ques_words)
         for r in records], q_len)
    ans_tokens = np.zeros((n, a_max, a_len), np.int32)
    ans_mask = np.zeros((n, a_max, a_len), np.float32)
    weights = np.zeros((n, a_max), np.float32)
    bias = np.zeros((n, a_max), np.float32)
    for i, r in enumerate(records):
        answers = r.get("answer", [])
        if isinstance(answers, str):
            answers = [answers]
        rb = r.get("bias")
        rb = (np.atleast_1d(np.asarray(rb, np.float32))
              if rb is not None else None)
        uniq: dict[str, float] = {}
        uniq_bias: dict[str, float] = {}
        for j, ans in enumerate(answers):
            uniq[ans] = uniq.get(ans, 0.0) + 1.0 / max(len(answers), 1)
            if rb is not None and j < len(rb):
                uniq_bias.setdefault(ans, float(rb[j]))
        items = list(uniq.items())[:a_max]
        if items:
            tk, tm = _tokenize_fixed(tokenizer, [t for t, _ in items], a_len,
                                     extra_eos=True)
            ans_tokens[i, : len(items)] = tk
            ans_mask[i, : len(items)] = tm
            weights[i, : len(items)] = [w for _, w in items]
        if rb is not None:
            bias[i, : len(items)] = [uniq_bias.get(t, 0.0) for t, _ in items]
    return MPlugEntries(
        question_ids=np.asarray(
            [r.get("question_id", i) for i, r in enumerate(records)],
            np.int64),
        question_tokens=q_tokens, question_mask=q_mask,
        answer_tokens=ans_tokens, answer_mask=ans_mask,
        weights=weights, bias=bias,
        image_paths=[os.path.join(vqa_root, r["image"]) for r in records])


_POOLS: dict[int, ThreadPoolExecutor] = {}


def load_images(paths: Sequence[str], image_res: int = 384,
                workers: int = 0, raw: bool = False) -> np.ndarray:
    """Decode + the eval transform (resize, CLIP normalise; `raw=True`
    keeps the resized uint8 pixels for the device-normalise path):
    [N, res, res, 3] float32 (or uint8). PIL is imported here only.
    `workers` > 0 decodes on a persistent thread pool."""
    from PIL import Image

    from .augment import test_transform

    out = np.zeros((len(paths), image_res, image_res, 3),
                   np.uint8 if raw else np.float32)

    def one(i: int) -> None:
        out[i] = test_transform(Image.open(paths[i]).convert("RGB"),
                                image_res, raw=raw)

    if workers > 0 and len(paths) > 1:
        pool = _POOLS.setdefault(workers, ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="load_images"))
        list(pool.map(one, range(len(paths))))
    else:
        for i in range(len(paths)):
            one(i)
    return out


def synthetic_mplug_batch(batch_size: int = 2, image_res: int = 32,
                          vocab_size: int = 128, q_len: int = 6,
                          a_len: int = 5, answers_per_question: int = 3,
                          seed: int = 0, uint8_images: bool = False) -> dict:
    """The JAX package's synthetic batch, bit for bit (numpy RandomState
    draws in the same order)."""
    rng = np.random.RandomState(seed)
    return {
        "images": (rng.randint(0, 256,
                               (batch_size, image_res, image_res, 3)
                               ).astype(np.uint8) if uint8_images else
                   rng.randn(batch_size, image_res, image_res, 3
                             ).astype(np.float32)),
        "question_ids": rng.randint(1, vocab_size,
                                    (batch_size, q_len)).astype(np.int32),
        "question_mask": np.ones((batch_size, q_len), np.float32),
        "answer_ids": rng.randint(
            1, vocab_size,
            (batch_size, answers_per_question, a_len)).astype(np.int32),
        "answer_mask": np.ones((batch_size, answers_per_question, a_len),
                               np.float32),
        "weights": rng.dirichlet(np.ones(answers_per_question),
                                 batch_size).astype(np.float32),
        "bias": rng.rand(batch_size,
                         answers_per_question).astype(np.float32) * 0.5,
        "qid": np.arange(batch_size, dtype=np.int64) + seed * batch_size,
    }


def iterate_batches(entries: MPlugEntries, batch_size: int,
                    image_res: int = 384, shuffle: bool = False,
                    seed: int = 0, drop_last: bool = False,
                    augment: bool = False, workers: int = 0,
                    raw_images: bool = False) -> Iterator[dict]:
    """Fixed-shape numpy batches in the JAX package's order (the same
    `RandomState(seed)` shuffle). A ragged final batch is padded with its
    last row and flagged in "valid"; consumers skip the pad rows."""
    if augment:
        raise NotImplementedError(
            "--augment true (RandomResizedCrop + HFlip + RandAugment): not "
            "yet ported to crvqa_tpu_torch (ROADMAP); pass --augment false")
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
            valid[len(idx):] = False
            idx = np.concatenate([idx,
                                  np.full(batch_size - len(idx), idx[-1])])
        yield {
            "valid": valid,
            "images": load_images([entries.image_paths[i] for i in idx],
                                  image_res, workers=workers, raw=raw_images),
            "question_ids": entries.question_tokens[idx],
            "question_mask": entries.question_mask[idx],
            "answer_ids": entries.answer_tokens[idx],
            "answer_mask": entries.answer_mask[idx],
            "weights": entries.weights[idx],
            "bias": entries.bias[idx],
            "qid": entries.question_ids[idx],
        }
