"""What a run is fed, made on the device from `--seed`: the model's weights
and a pool of distinct batches. The same seed gives the same tensors, so
the program and the reference are handed the same inputs.

Weights: one normal draw for every 'linear', 'embed' and 'bias' leaf and
one uniform draw for the classifier's, each leaf a view of its draw
scaled in place; LayerNorms are ones and zeros. A batch: questions of
`traffic.question_tokens` lengths (the rest padding, id 0), token ids
uniform over the vocabulary, one feature vector per box, box positions in
[0, 1), 1-3 soft answers per question and a bias prior per answer, as
`traffic` states.
"""
from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one stream (`tag`) of a run's `--seed`: the streams of one
    run never share a generator's sequence."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % 2 ** 63


def make_weights(table, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter of `table` ((name, shape, init) rows) in float32 on
    `device`, from two large draws of a generator on the device."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                             "weights"))
    normal = [r for r in table if r[2] in ("linear", "embed", "bias")]
    uniform = [r for r in table if r[2] in ("wn_v", "wn_b")]
    size = lambda rows: sum(math.prod(s) for _, s, _ in rows)
    flat_n = torch.randn(size(normal), generator=gen, device=device)
    flat_u = torch.rand(size(uniform), generator=gen, device=device)
    flat_u.mul_(2.0).sub_(1.0)
    out: dict[str, torch.Tensor] = {}
    views = {}
    for rows, flat in ((normal, flat_n), (uniform, flat_u)):
        at = 0
        for name, shape, _ in rows:
            n = math.prod(shape)
            views[name] = flat[at:at + n].view(shape)
            at += n
    fan_in = {}
    for name, shape, init in table:
        if init in ("linear", "wn_v"):
            fan_in[name.rsplit(".", 1)[0]] = shape[1]
    with torch.no_grad():
        for name, shape, init in table:
            module = name.rsplit(".", 1)[0]
            if init == "linear":
                t = views[name].mul_(1.0 / math.sqrt(shape[1]))
            elif init in ("embed", "bias"):
                t = views[name].mul_(0.02)
            elif init in ("wn_v", "wn_b"):
                t = views[name].mul_(1.0 / math.sqrt(fan_in[module]))
            elif init == "wn_g":
                t = out[f"{module}.weight_v"].norm().reshape(())
            elif init == "ones":
                t = torch.ones(shape, device=device)
            elif init == "zeros":
                t = torch.zeros(shape, device=device)
            else:
                raise ValueError(f"{name}: unknown init {init!r}")
            out[name] = t
    return out


def make_pool(cfg: dict, trf: dict, style: str, seed: int, device
              ) -> list[dict]:
    """`traffic.pool_batches` distinct batches of `traffic.batch_size`
    rows. `style` 'lxmert': visual_feats and visual_pos; 'visualbert':
    visual_embeds."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "pool"))
    b = trf["batch_size"]
    q = trf["question_tokens"]
    boxes, n_ans = trf["boxes"], cfg["ans_num"]
    vdt = getattr(torch, trf["visual_dtype"])
    ans = trf["answers"]
    scores = torch.tensor(ans["scores"], device=device)
    feat_dim = cfg["visual_feat_dim" if style == "lxmert"
                   else "visual_embedding_dim"]
    out = []
    for _ in range(trf["pool_batches"]):
        lengths = torch.randint(q["min"], q["max"] + 1, (b, 1), generator=gen,
                                device=device)
        pos = torch.arange(q["max"], device=device)[None, :]
        mask = (pos < lengths).float()
        ids = torch.randint(1, cfg["vocab_size"], (b, q["max"]),
                            generator=gen, device=device)
        ids = torch.where(mask > 0, ids, torch.zeros_like(ids))
        feats = torch.randn(b, boxes, feat_dim, generator=gen,
                            device=device).to(vdt)
        k = torch.randint(ans["min"], ans["max"] + 1, (b, 1), generator=gen,
                          device=device)
        idx = torch.randint(0, n_ans, (b, ans["max"]), generator=gen,
                            device=device)
        pick = torch.randint(0, len(ans["scores"]), (b, ans["max"]),
                             generator=gen, device=device)
        slot = torch.arange(ans["max"], device=device)[None, :]
        labels = torch.zeros(b, n_ans, device=device)
        # amax: a deterministic pick where two draws name one answer
        labels.scatter_reduce_(1, idx, torch.where(slot < k, scores[pick],
                                                   0.0), reduce="amax")
        bias = torch.rand(b, n_ans, generator=gen, device=device) * trf[
            "bias_scale"]
        batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
                 "bias": bias}
        if style == "visualbert":
            batch["visual_embeds"] = feats
        else:
            batch["visual_feats"] = feats
            batch["visual_pos"] = torch.rand(
                b, boxes, cfg["visual_pos_dim"], generator=gen,
                device=device).to(vdt)
        out.append(batch)
    return out
