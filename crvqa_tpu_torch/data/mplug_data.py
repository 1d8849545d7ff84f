"""mPLUG serving data (the port's copy of what serving needs from
`crvqa_tpu/data/mplug_data.py`): fixed-length question and answer
tokenization, the OCR / object question splicing, the eval image loader and
synthetic batches. The training loaders wait for the training slice."""
from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np


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
