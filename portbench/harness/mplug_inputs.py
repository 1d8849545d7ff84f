"""What an mPLUG training run is fed, made on the device from `--seed`
(`inputs.sub_seed`'s 'pool' stream, so the program and the reference are
handed the same tensors): `traffic.pool_batches` batches of
`traffic.batch_size` questions, each

- an image of `image_res` x `image_res` uint8 pixels, uniform over 0-255
  (the CLI's `--device_normalize` layout, [B, H, W, 3]);
- a question of `question_tokens` min-max real tokens, ids uniform over
  the vocabulary, padded with id 0 to the max (the mask 1 / 0);
- `answers.slots` answer slots of `answers.tokens` tokens: the first k
  filled, k uniform in 1..slots; a filled slot holds [CLS], `answers.words`
  min-max word ids, [SEP] [SEP] (the file path's `answer + eos` rows),
  padded with 0; an empty slot is all padding;
- weights count / votes over the filled slots: `answers.votes`
  annotator answers, one for each filled slot and the rest uniform over
  them (the file path's count / len(answers)); 0 on the padding;
- a (1 - bias) prior uniform in [0, `bias_scale`) per slot.
"""
from __future__ import annotations

import torch

from .inputs import sub_seed


def make_pool(cfg: dict, trf: dict, seed: int, device) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "pool"))
    b, res, vocab = trf["batch_size"], cfg["image_res"], cfg["vocab_size"]
    q, ans = trf["question_tokens"], trf["answers"]
    slots, length = ans["slots"], ans["tokens"]
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen,
                                             device=device)
    out = []
    for _ in range(trf["pool_batches"]):
        images = torch.randint(0, 256, (b, res, res, 3), generator=gen,
                               device=device, dtype=torch.uint8)
        lengths = ri(q["min"], q["max"] + 1, (b, 1))
        qmask = (torch.arange(q["max"], device=device)[None] < lengths)
        qids = torch.where(qmask, ri(1, vocab, (b, q["max"])), 0)
        filled = ri(1, slots + 1, (b, 1))
        words = ri(ans["words"]["min"], ans["words"]["max"] + 1,
                   (b, slots, 1))
        tok = torch.arange(length, device=device)[None, None]
        ids = ri(1, vocab, (b, slots, length))
        ids = torch.where(tok == 0, cfg["bos_token_id"], ids)
        ids = torch.where((tok > words) & (tok <= words + 2),
                          cfg["eos_token_id"], ids)
        amask = tok <= words + 2
        live = torch.arange(slots, device=device)[None] < filled
        amask = amask & live[..., None]
        ids = torch.where(amask, ids, 0)
        votes = torch.arange(ans["votes"], device=device)[None]
        extra = (torch.rand(b, ans["votes"], generator=gen, device=device)
                 * filled).long().clamp_max(slots - 1)
        votes = torch.where(votes < filled, votes, extra)
        counts = torch.nn.functional.one_hot(votes, slots).sum(dim=1)
        bias = torch.rand(b, slots, generator=gen, device=device) * trf[
            "bias_scale"]
        out.append({"images": images, "question_ids": qids,
                    "question_mask": qmask.float(), "answer_ids": ids,
                    "answer_mask": amask.float(),
                    "weights": counts.float() / ans["votes"], "bias": bias})
    return out
