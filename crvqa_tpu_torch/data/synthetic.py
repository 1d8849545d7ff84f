"""Synthetic VQA batches with the exact shapes of the real pipeline (a copy
of `crvqa_tpu/data/synthetic.py`: the same seed gives the same numpy
batch in both packages, so parity tests feed both sides alike).

Shapes mirror
`dataset_LXM.py` / `TrimCollator`: 14 question tokens, 36 Faster-RCNN boxes
with 2048-d features + 4-d spatials, soft targets over the answer vocabulary
(2274 for VQA-CP v2), per-example bias prior and argmax label.
"""
from __future__ import annotations

import numpy as np


def synthetic_batch(batch_size: int = 8, seq_len: int = 14, num_boxes: int = 36,
                    feat_dim: int = 2048, pos_dim: int = 4, ans_num: int = 2274,
                    vocab_size: int = 30522, seed: int = 0,
                    style: str = "lxmert") -> dict:
    """style='lxmert' -> (visual_feats, visual_pos); 'visualbert' -> visual_embeds."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((batch_size, ans_num), np.float32)
    for i in range(batch_size):
        k = rng.randint(1, 4)
        idx = rng.choice(ans_num, size=k, replace=False)
        labels[i, idx] = rng.choice([0.3, 0.6, 0.9, 1.0], size=k)
    bias = rng.rand(batch_size, ans_num).astype(np.float32) * 0.5
    batch = {
        "input_ids": rng.randint(0, vocab_size, (batch_size, seq_len)).astype(np.int32),
        "attention_mask": np.ones((batch_size, seq_len), np.float32),
        "labels": labels,
        "bias": bias,
        "max_label": labels.argmax(axis=1).astype(np.int32),
        "question_id": np.arange(batch_size, dtype=np.int64) + seed * batch_size,
        "valid": np.ones((batch_size,), bool),
    }
    if style == "visualbert":
        batch["visual_embeds"] = rng.randn(
            batch_size, num_boxes, feat_dim).astype(np.float32)
    else:
        batch["visual_feats"] = rng.randn(
            batch_size, num_boxes, feat_dim).astype(np.float32)
        batch["visual_pos"] = rng.rand(
            batch_size, num_boxes, pos_dim).astype(np.float32)
    return batch


def synthetic_batches(n: int, **kw):
    for i in range(n):
        yield synthetic_batch(seed=i, **kw)
