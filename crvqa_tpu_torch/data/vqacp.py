"""VQA-CP v2 serving inputs (the slice of `crvqa_tpu/data/vqacp.py` the
server uses): fixed-14 question tokenization, the answer vocabulary, and
the image-feature stores.

File contract as the reference's (`dataset_LXM.py:118-179`):
  <dataroot>/cache/train_test_ans2label.pkl / train_test_label2ans.pkl
  image feature pickle {image_id: {'feats': [36, 2048], 'sp_feats': [36, 4]}}
  or the native `.bin` store (`native/feature_store.py`).
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np


def tokenize_questions(questions: Sequence[str], tokenizer,
                       max_length: int = 14
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-length-14 WordPiece ids padded with [PAD]
    (`VQAFeatureDataset.tokenize`, dataset_LXM.py:189-226: no [CLS]/[SEP],
    truncate-or-pad to 14). Returns (ids [N, 14] int32, lengths [N])."""
    pad_id = tokenizer.convert_tokens_to_ids("[PAD]")
    ids = np.full((len(questions), max_length), pad_id, np.int32)
    lengths = np.zeros(len(questions), np.int32)
    for i, q in enumerate(questions):
        toks = tokenizer.tokenize(q)[:max_length]
        ids[i, : len(toks)] = tokenizer.convert_tokens_to_ids(toks)
        lengths[i] = len(toks)
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
