"""Plain PyTorch mPLUG mask training for VQA (Li et al., 2022, "mPLUG:
Effective and Efficient Vision-Language Learning by Cross-modal
Skip-connections", arXiv:2205.12005; the layout of the public code,
https://github.com/alibaba/AliceMind/tree/main/mPLUG, at `clip_name:
ViT-B-16` and `config_bert_stride3.json`), written from the published
equations of its four towers:

- the visual encoder, CLIP's ViT (Radford et al., 2021): patch embedding,
  [class; patches] + positions, `ln_pre`, pre-LN blocks x += attn(ln_1(x))
  and x += c_proj(quick_gelu(c_fc(ln_2(x)))) with one fused q/k/v
  projection, then `ln_post` (LayerNorm eps 1e-5);
- the text encoder, post-LN BERT layers (Devlin et al., 2019): y =
  LN(dropout(dense(sublayer(x))) + x) after the self-attention and the
  FFN (exact erf gelu, eps 1e-12);
- the fusion encoder with cross-modal skip-connections: the text attends
  to itself, then to the image tokens; every `stride_layer`-th relative
  layer (not the first) instead runs one joint self-attention and FFN over
  [image; text] and adds the image half back onto the image stream;
- the answer decoder: causal self-attention over the answer tokens, then
  cross-attention to the [image; question] memory, the FFN, and the LM
  head (dense, gelu, LayerNorm, the word embeddings transposed, a bias).

The loss is the weighted, (1 - bias)-reweighted answer LM loss: per answer
slot the summed next-token cross-entropy over its non-pad targets, times
the slot's weight and (1 - its bias), summed over slots and divided by the
questions.

Departures from a straight transcription, each the same function:
- the patch embedding is the stride-P convolution as a product over
  flattened patches, so every product takes the stated precision;
- the decoder's cross-attention runs grouped, as the program runs it: the
  A answer rows of a question form one query block of A*L rows over the
  question's memory, read once (a replicated memory gives the same
  logits; `answer_logits(..., grouped=False)` computes it that way);
- dropout is the program's contract (`Replay`): each attention draws from
  the generator of the path the program's dispatch takes at that shape
  (`route`, a copy of its rule), the counter-hash keep mask of the short
  kernel (`common.attention_keep`) or of the mid-length kernel
  (`midseq_keep`, keyed on the absolute head and the plain key index), or
  a device draw on the eager path.

Mask training (`MPlugReference`): every masked weight w carries a score s,
|w| at the start with the threshold t the k-th smallest |w| of its matrix
(k = int(n * zero rate)); the model runs on w * [s > t]. A step takes the
gradient of each masked weight straight through to its score (ds = dW *
w), and of the LM head's transform and bias, clips them all to one global
norm, and steps them with AdamW in two groups (the visual encoder's at
lr2, the rest at lr1; no decay on biases and LayerNorm weights) under the
reference loop's epoch schedule. A reset sets each t to the k-th smallest
of its scores. The batch runs in blocks of questions whose gradients add.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .common import (FP32, Precision, attention_keep, clip_by_global_norm,
                     gelu, keep_threshold, layer_norm, linear, matmul)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_MASK32 = 0xFFFFFFFF
# the program's short attention kernel takes H * S <= this on both sides
SHORT_HEADS_TIMES_SEQ = 1024
VIT = "visual_encoder.visual"
DEC = "text_decoder"
HEAD = "text_decoder.cls.predictions"


# ------------------------------------------------------------ parameters

def is_stride(cfg: dict, rel: int) -> bool:
    return rel != 0 and rel % cfg["stride_layer"] == 0


def _bert_layer(pre: str, h: int, inter: int, cross: bool,
                dense, norm) -> None:
    for block in ("attention",) + (("crossattention",) if cross else ()):
        for m in ("query", "key", "value"):
            dense(f"{pre}.{block}.self.{m}", h, h)
        dense(f"{pre}.{block}.output.dense", h, h)
        norm(f"{pre}.{block}.output.LayerNorm", h)
    dense(f"{pre}.intermediate.dense", h, inter)
    dense(f"{pre}.output.dense", inter, h)
    norm(f"{pre}.output.LayerNorm", h)


def param_table(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in the program's module
    order and by its state_dict names. init: 'linear' N(0, 1/fan_in),
    'embed' N(0, 0.02) (also the patch embedding, whose fan-in is not its
    second axis), 'bias' N(0, 0.02), 'ones', 'zeros'."""
    t: list = []

    def dense(name, n_in, n_out):
        t.extend([(f"{name}.weight", (n_out, n_in), "linear"),
                  (f"{name}.bias", (n_out,), "bias")])

    def norm(name, width):
        t.extend([(f"{name}.weight", (width,), "ones"),
                  (f"{name}.bias", (width,), "zeros")])

    w, p = cfg["vision_width"], cfg["patch_size"]
    grid = (cfg["image_res"] // p) ** 2
    t += [(f"{VIT}.class_embedding", (w,), "embed"),
          (f"{VIT}.positional_embedding", (grid + 1, w), "embed"),
          (f"{VIT}.conv1.weight", (w, 3, p, p), "embed")]
    norm(f"{VIT}.ln_pre", w)
    for i in range(cfg["vision_layers"]):
        pre = f"{VIT}.transformer.resblocks.{i}"
        norm(f"{pre}.ln_1", w)
        t.extend([(f"{pre}.attn.in_proj_weight", (3 * w, w), "linear"),
                  (f"{pre}.attn.in_proj_bias", (3 * w,), "bias")])
        dense(f"{pre}.attn.out_proj", w, w)
        norm(f"{pre}.ln_2", w)
        dense(f"{pre}.mlp.c_fc", w, 4 * w)
        dense(f"{pre}.mlp.c_proj", 4 * w, w)
    norm(f"{VIT}.ln_post", w)
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]

    def embeddings(pre):
        t.extend([(f"{pre}.word_embeddings.weight", (cfg["vocab_size"], h),
                   "embed"),
                  (f"{pre}.position_embeddings.weight",
                   (cfg["max_position_embeddings"], h), "embed"),
                  (f"{pre}.token_type_embeddings.weight",
                   (cfg["type_vocab_size"], h), "embed")])
        norm(f"{pre}.LayerNorm", h)

    embeddings("text_encoder.embeddings")
    for i in range(cfg["text_encoder_layers"]):
        _bert_layer(f"text_encoder.encoder.layer.{i}", h, inter, False,
                    dense, norm)
    for rel in range(cfg["fusion_layers"]):
        i = cfg["text_encoder_layers"] + rel
        _bert_layer(f"fusion_encoder.encoder.layer.{i}", h, inter,
                    not is_stride(cfg, rel), dense, norm)
    embeddings(f"{DEC}.bert.embeddings")
    for i in range(cfg["text_decode_layers"]):
        _bert_layer(f"{DEC}.bert.encoder.layer.{i}", h, inter, True, dense,
                    norm)
    t.append((f"{HEAD}.bias", (cfg["vocab_size"],), "zeros"))
    dense(f"{HEAD}.transform.dense", h, h)
    norm(f"{HEAD}.transform.LayerNorm", h)
    return t


def masked_weights(cfg: dict) -> list[tuple[str, str]]:
    """(weight name, modality) of every masked matrix (one uniform rate):
    both MLP matrices of every ViT block; K, Q, V, the attention output,
    the intermediate and the output dense of every text-encoder layer;
    the same of every fusion layer, plus its cross-attention's four unless
    it is a stride layer; all ten of every decoder layer."""
    sub = ["attention.self.key", "attention.self.query",
           "attention.self.value", "attention.output.dense"]
    cross = [s.replace("attention", "crossattention", 1) for s in sub]
    ffn = ["intermediate.dense", "output.dense"]
    out = []
    for i in range(cfg["vision_layers"]):
        pre = f"{VIT}.transformer.resblocks.{i}.mlp"
        out += [f"{pre}.c_fc.weight", f"{pre}.c_proj.weight"]
    for i in range(cfg["text_encoder_layers"]):
        out += [f"text_encoder.encoder.layer.{i}.{s}.weight"
                for s in sub + ffn]
    for rel in range(cfg["fusion_layers"]):
        i = cfg["text_encoder_layers"] + rel
        subs = sub + ffn + ([] if is_stride(cfg, rel) else cross)
        out += [f"fusion_encoder.encoder.layer.{i}.{s}.weight" for s in subs]
    for i in range(cfg["text_decode_layers"]):
        out += [f"{DEC}.bert.encoder.layer.{i}.{s}.weight"
                for s in sub + cross + ffn]
    return [(n, "Uni") for n in out]


def head_params(cfg: dict) -> list[str]:
    """The LM head's transform and bias: trained beside the scores."""
    return [n for n, _, _ in param_table(cfg) if n.startswith(HEAD + ".")]


# --------------------------------------------------------------- dropout

def supported(batch: int, sq: int, sk: int, heads: int, head_size: int,
              itemsize: int) -> bool:
    """The program's admission rule for its mid-length kernel: the JAX
    kernel's recompute backward within a 12 MiB budget at Sq padded to 16
    and Sk to 128 (two buffers of the io blocks of the narrowest
    128-aligned head group plus four fp32 [Sq, Sk] planes)."""
    if batch < 1 or sq < 1 or sk < 1:
        return False
    hg = next((g for g in range(1, heads)
               if heads % g == 0 and g * head_size % 128 == 0), heads)
    wd = hg * head_size
    sqp, skp = -(-sq // 16) * 16, -(-sk // 128) * 128
    io = (3 * sqp * wd + 4 * skp * wd) * itemsize + skp * 4
    return 2 * io + 4 * sqp * skp * 4 <= 12 * 1024 * 1024


def route(batch: int, sq: int, sk: int, heads: int, head_size: int,
          keywise: bool, short_kernel: bool, itemsize: int) -> str:
    """The path the program's dispatch takes: 'short' (H*Sq and H*Sk
    within 1024, a key-wise bias, and not the ViT), 'midseq' (a key-wise
    bias past that, admitted by `supported`), else 'eager'."""
    short = (sq * heads <= SHORT_HEADS_TIMES_SEQ
             and sk * heads <= SHORT_HEADS_TIMES_SEQ)
    if keywise and short and short_kernel:
        return "short"
    if keywise and not short and supported(batch, sq, sk, heads, head_size,
                                           itemsize):
        return "midseq"
    return "eager"


def midseq_keep(rows: torch.Tensor, heads: int, sq: int, sk: int,
                rate: float, seed: int) -> torch.Tensor:
    """Bool keep mask [len(rows), H, Sq, Sk] of the mid-length kernel's
    counter hash, keyed on (seed, global batch row, absolute head h, query
    i, key j), in uint32 arithmetic carried in int64."""
    dev = rows.device
    h = torch.arange(heads, dtype=torch.int64, device=dev)
    key = ((((seed & _MASK32) * 2654435761) & _MASK32)
           + rows.to(torch.int64)[:, None] * 97531
           + ((h[None] * 1000003) & _MASK32)) & _MASK32      # [b, H]
    i = torch.arange(sq, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(sk, dtype=torch.int64, device=dev)[None, :]
    x = (i * 374761393 + j * 668265263) & _MASK32
    x = (x + key[:, :, None, None]) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 1274126177) & _MASK32
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


class Replay:
    """One training step's randomness, replayed from its generators: the
    hidden dropout masks and the eager attention's are `torch.rand(shape)
    < 1 - rate` from the step's device generator, one whole-batch draw per
    site in the model's order; each kernel attention draws one int32 seed
    from the host generator. The first block draws every site as it
    reaches it; later blocks read the same sites in the same order.
    `None` generators (eval, or counting on `meta`) drop nothing; `log`
    collects (batch, heads, Sq, Sk, head size, with backward) of every
    attention call."""

    def __init__(self, device_gen: Optional[torch.Generator],
                 host_gen: Optional[torch.Generator],
                 log: Optional[list] = None):
        self.device_gen, self.host_gen, self.log = device_gen, host_gen, log
        self.masks: list[torch.Tensor] = []
        self.seeds: list[int] = []
        self.q = self.a = slice(0, None)
        self._h = self._s = 0

    @property
    def live(self) -> bool:
        return self.device_gen is not None

    def block(self, q0: int, q1: int, answers: int) -> "Replay":
        """Restart the cursors for questions [q0, q1), whose answer rows
        are [q0 * answers, q1 * answers)."""
        self.q, self.a = slice(q0, q1), slice(q0 * answers, q1 * answers)
        self._h = self._s = 0
        return self

    def keep(self, whole: tuple, rate: float, rows: slice,
             device) -> torch.Tensor:
        """The next site's keep mask, drawn for the whole batch `whole`,
        restricted to `rows`."""
        if self._h == len(self.masks):
            r = torch.rand(whole, generator=self.device_gen, device=device)
            self.masks.append(r < 1.0 - rate)
        m = self.masks[self._h]
        if tuple(m.shape) != tuple(whole):
            raise RuntimeError(f"dropout site {self._h}: {tuple(whole)} "
                               f"where the first block drew "
                               f"{tuple(m.shape)}")
        self._h += 1
        return m[rows]

    def hidden(self, x: torch.Tensor, rate: float, whole_rows: int,
               rows: slice) -> torch.Tensor:
        if not self.live or rate == 0.0:
            return x
        keep = self.keep((whole_rows,) + tuple(x.shape[1:]), rate, rows,
                         x.device)
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), device=x.device))

    def seed(self) -> int:
        if self._s == len(self.seeds):
            self.seeds.append(int(torch.randint(
                -2 ** 31, 2 ** 31, (), generator=self.host_gen)))
        s = self.seeds[self._s]
        self._s += 1
        return s


# -------------------------------------------------------------- the model

class _Model:
    """The four towers over one parameter dict, for a block of questions
    (`Replay.block`) of a whole batch of `batch` questions."""

    def __init__(self, p: dict, cfg: dict, draws: Replay, prec: Precision,
                 batch: int, answers: int):
        self.p, self.cfg, self.draws, self.prec = p, cfg, draws, prec
        self.batch, self.answers = batch, answers
        live = draws.live
        self.rate_h = cfg["hidden_dropout_prob"] if live else 0.0
        self.rate_a = cfg["attention_probs_dropout_prob"] if live else 0.0
        self.rate_v = cfg["attn_dropout"] if live else 0.0
        self.itemsize = 2 if cfg["dtype"] == "bfloat16" else 4

    def dense(self, name, x):
        return linear(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                      self.prec)

    def norm(self, name, x, eps):
        return layer_norm(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                          eps)

    def attention(self, q, k, v, key_bias, heads: int, rate: float,
                  whole: int, rows: slice, global_rows: torch.Tensor,
                  keywise: bool = True, short_kernel: bool = True):
        """softmax(q k^T / sqrt(D) + bias) with the dispatched path's
        dropout, then @ v. q [b, Sq, H*D]; k, v [b, Sk, H*D]; `key_bias`
        broadcastable to [b, H, Sq, Sk] or None; `whole` rows in the whole
        batch, this block's `rows` of them, `global_rows` their indices."""
        b, sq, hd = q.shape
        sk, d = k.shape[1], hd // heads
        dr = self.draws
        if dr.log is not None:
            dr.log.append((b, heads, sq, sk, d, q.requires_grad))
        split = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
        s = matmul(split(q), split(k).transpose(-1, -2), self.prec)
        s = s / math.sqrt(d)
        if key_bias is not None:
            s = s + key_bias
        p = torch.softmax(s, dim=-1)
        if dr.live and rate:
            path = route(whole, sq, sk, heads, d, keywise, short_kernel,
                         self.itemsize)
            if path == "eager":
                keep = dr.keep((whole, heads, sq, sk), rate, rows, q.device)
            elif path == "short":
                keep = attention_keep(global_rows, sq, heads * sk, rate,
                                      dr.seed())
                keep = keep.reshape(b, sq, heads, sk).transpose(1, 2)
            else:
                keep = midseq_keep(global_rows, heads, sq, sk, rate,
                                   dr.seed())
            p = torch.where(keep, p / (1.0 - rate),
                            torch.zeros((), device=p.device))
        ctx = matmul(p, split(v), self.prec)
        return ctx.transpose(1, 2).reshape(b, sq, hd)

    # ---------------------------------------------------------------- ViT
    def visual(self, images):
        cfg, p = self.cfg, self.p
        w, ps = cfg["vision_width"], cfg["patch_size"]
        mean = torch.tensor(CLIP_MEAN, device=images.device)
        std = torch.tensor(CLIP_STD, device=images.device)
        x = (images.float() / 255.0 - mean) / std
        b, hh, ww, _ = x.shape
        gy, gx = hh // ps, ww // ps
        x = x[:, :gy * ps, :gx * ps].reshape(b, gy, ps, gx, ps, 3)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gy * gx, 3 * ps * ps)
        x = matmul(x, p[f"{VIT}.conv1.weight"].reshape(w, -1).t(), self.prec)
        cls = p[f"{VIT}.class_embedding"].expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + p[f"{VIT}.positional_embedding"]
        x = self.norm(f"{VIT}.ln_pre", x, 1e-5)
        dr, heads = self.draws, cfg["vision_heads"]
        rows = dr.q
        grows = torch.arange(rows.start, rows.start + b, device=x.device)
        for i in range(cfg["vision_layers"]):
            pre = f"{VIT}.transformer.resblocks.{i}"
            y = self.norm(f"{pre}.ln_1", x, 1e-5)
            qkv = linear(y, p[f"{pre}.attn.in_proj_weight"],
                         p[f"{pre}.attn.in_proj_bias"], self.prec)
            q, k, v = qkv.chunk(3, dim=-1)
            a = self.attention(q, k, v, None, heads, self.rate_v, self.batch,
                               rows, grows, short_kernel=False)
            x = x + self.dense(f"{pre}.attn.out_proj", a)
            y = self.norm(f"{pre}.ln_2", x, 1e-5)
            y = self.dense(f"{pre}.mlp.c_fc", y)
            y = y * torch.sigmoid(1.702 * y)
            x = x + self.dense(f"{pre}.mlp.c_proj", y)
        return self.norm(f"{VIT}.ln_post", x, 1e-5)

    # --------------------------------------------------------------- BERT
    def embed(self, pre, ids, whole, rows):
        p = self.p
        h = (p[f"{pre}.word_embeddings.weight"][ids]
             + p[f"{pre}.position_embeddings.weight"][:ids.shape[1]][None]
             + p[f"{pre}.token_type_embeddings.weight"][0][None, None])
        h = self.norm(f"{pre}.LayerNorm", h, self.cfg["layer_norm_eps"])
        return self.draws.hidden(h, self.rate_h, whole, rows)

    def out(self, name, x, residual, whole, rows):
        y = self.draws.hidden(self.dense(f"{name}.dense", x), self.rate_h,
                              whole, rows)
        return self.norm(f"{name}.LayerNorm", y + residual,
                         self.cfg["layer_norm_eps"])

    def attend(self, pre, x, ctx, key_bias, whole, rows, grows,
               keywise=True):
        a = self.attention(self.dense(f"{pre}.self.query", x),
                           self.dense(f"{pre}.self.key", ctx),
                           self.dense(f"{pre}.self.value", ctx), key_bias,
                           self.cfg["num_attention_heads"], self.rate_a,
                           whole, rows, grows, keywise)
        return self.out(f"{pre}.output", a, x, whole, rows)

    def ffn(self, pre, x, whole, rows):
        y = gelu(self.dense(f"{pre}.intermediate.dense", x))
        return self.out(f"{pre}.output", y, x, whole, rows)

    def encode(self, batch):
        """(memory [b, 1 + P + Lq, h], its key bias [b, 1 + P + Lq]) of
        a block of questions."""
        cfg, dr = self.cfg, self.draws
        image = self.visual(batch["images"])
        qmask = batch["question_mask"].float()
        rows, whole = dr.q, self.batch
        b = qmask.shape[0]
        grows = torch.arange(rows.start, rows.start + b, device=qmask.device)
        text_bias = ((1.0 - qmask) * -10000.0)[:, None, None, :]
        image_bias = torch.zeros(b, 1, 1, image.shape[1],
                                 device=qmask.device)
        text = self.embed("text_encoder.embeddings", batch["question_ids"],
                          whole, rows)
        for i in range(cfg["text_encoder_layers"]):
            pre = f"text_encoder.encoder.layer.{i}"
            text = self.attend(f"{pre}.attention", text, text, text_bias,
                               whole, rows, grows)
            text = self.ffn(pre, text, whole, rows)
        for rel in range(cfg["fusion_layers"]):
            i = cfg["text_encoder_layers"] + rel
            pre = f"fusion_encoder.encoder.layer.{i}"
            if not is_stride(cfg, rel):
                text = self.attend(f"{pre}.attention", text, text, text_bias,
                                   whole, rows, grows)
                text = self.attend(f"{pre}.crossattention", text, image,
                                   image_bias, whole, rows, grows)
                text = self.ffn(pre, text, whole, rows)
                continue
            joint = torch.cat([image, text], dim=1)
            jbias = torch.cat([image_bias, text_bias], dim=3)
            joint = self.attend(f"{pre}.attention", joint, joint, jbias,
                                whole, rows, grows)
            joint = self.ffn(pre, joint, whole, rows)
            n = image.shape[1]
            image, text = image + joint[:, :n], joint[:, n:]
        memory = torch.cat([image, text], dim=1)
        mem_bias = torch.cat([torch.zeros(b, image.shape[1],
                                          device=qmask.device),
                              (1.0 - qmask) * -10000.0], dim=1)
        return memory, mem_bias

    def decode(self, memory, mem_bias, answer_ids, answer_mask,
               grouped: bool = True):
        """Logits [b * A, L, V] of a block's answer rows."""
        cfg, p, dr = self.cfg, self.p, self.draws
        b, a, length = answer_ids.shape
        n, whole_n = b * a, self.batch * a
        ids = answer_ids.reshape(n, length)
        amask = answer_mask.reshape(n, length).float()
        causal = torch.tril(torch.ones(length, length, device=ids.device))
        self_bias = (((1.0 - causal) * -10000.0)[None, None]
                     + ((1.0 - amask) * -10000.0)[:, None, None, :])
        qrows, arows = dr.q, dr.a
        gq = torch.arange(qrows.start, qrows.start + b, device=ids.device)
        ga = torch.arange(arows.start, arows.start + n, device=ids.device)
        if not grouped:
            memory = memory.repeat_interleave(a, dim=0)
            mem_bias = mem_bias.repeat_interleave(a, dim=0)
        mbias = mem_bias[:, None, None, :]
        x = self.embed(f"{DEC}.bert.embeddings", ids, whole_n, arows)
        for i in range(cfg["text_decode_layers"]):
            pre = f"{DEC}.bert.encoder.layer.{i}"
            x = self.attend(f"{pre}.attention", x, x, self_bias, whole_n,
                            arows, ga, keywise=False)
            if grouped:
                h = x.reshape(b, a * length, x.shape[-1])
                h = self.attend(f"{pre}.crossattention", h, memory, mbias,
                                self.batch, qrows, gq)
                x = h.reshape(n, length, x.shape[-1])
            else:
                x = self.attend(f"{pre}.crossattention", x, memory, mbias,
                                whole_n, arows, ga)
            x = self.ffn(pre, x, whole_n, arows)
        t = layer_norm(gelu(self.dense(f"{HEAD}.transform.dense", x)),
                       p[f"{HEAD}.transform.LayerNorm.weight"],
                       p[f"{HEAD}.transform.LayerNorm.bias"],
                       cfg["layer_norm_eps"])
        table = p[f"{DEC}.bert.embeddings.word_embeddings.weight"]
        return matmul(t, table.t(), self.prec) + p[f"{HEAD}.bias"]


def lm_loss_rows(logits, ids, pad_id: int):
    """Per answer row: the summed next-token cross-entropy over its
    non-pad targets."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = ids[:, 1:]
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * (targets != pad_id).float()).sum(dim=1)


def answer_logits(p: dict, batch: dict, cfg: dict, draws: Replay,
                  prec: Precision = FP32, batch_size: int = None,
                  grouped: bool = True):
    """The decoder's logits [b * A, L, V] of a block of questions.
    `batch_size`: the whole batch's questions."""
    b, a, _ = batch["answer_ids"].shape
    m = _Model(p, cfg, draws, prec, batch_size or b, a)
    memory, mem_bias = m.encode(batch)
    return m.decode(memory, mem_bias, batch["answer_ids"],
                    batch["answer_mask"], grouped)


def loss_sum(p: dict, batch: dict, cfg: dict, draws: Replay,
             prec: Precision = FP32, batch_size: int = None):
    """The block's summed sum(weight * (1 - bias) * answer LM loss); the
    batch loss is its sum over the blocks over the whole batch's
    questions."""
    ids = batch["answer_ids"]
    b, a, length = ids.shape
    logits = answer_logits(p, batch, cfg, draws, prec, batch_size)
    per = lm_loss_rows(logits, ids.reshape(b * a, length),
                       cfg["pad_token_id"])
    w = batch["weights"].reshape(b * a) * (1.0 - batch["bias"].reshape(
        b * a))
    return (w * per).sum()


# -------------------------------------------------------------- training

def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.kthvalue(flat, min(max(int(k), 1), flat.numel())).values


def epoch_lr(step: int, lr: float, sched: dict) -> float:
    """The reference loop's rate at `step` (timm's CosineLRScheduler with
    a warm-up prefix, driven by epoch: in epoch 0 the warm-up advances one
    unit every 100 iterations up to `warmup_epochs`; epoch e >= 1 runs at
    unit e - 1 + warmup_epochs). Warm-up: linear from `warmup_lr` to lr
    over `warmup_epochs` units; then min_lr + (lr - min_lr) / 2 * (1 +
    cos(pi * t / epochs)) on the post-warm-up clock, min_lr past one
    cycle."""
    spe, warm = max(int(sched["steps_per_epoch"]), 1), sched["warmup_epochs"]
    cap = min(warm, (spe - 1) // 100) if warm > 0 else 0
    e = step // spe
    t = min(max((step - 1) // 100, 0), cap) if e == 0 else e - 1 + warm
    if warm > 0 and t < warm:
        return sched["warmup_lr"] + t * (lr - sched["warmup_lr"]) / warm
    td, epochs = t - warm, max(int(sched["epochs"]), 1)
    if td >= epochs:
        return sched["min_lr"]
    return sched["min_lr"] + 0.5 * (lr - sched["min_lr"]) * (
        1.0 + math.cos(math.pi * td / epochs))


class MPlugReference:
    """The reference's mask-training state, worked out from the weights
    and the seed alone. `weights`: every parameter by name, float32 on the
    device the reference runs on; `opt`: lr1, lr2, weight_decay,
    max_grad_norm and the schedule's `sched` entries."""

    def __init__(self, cfg: dict, opt: dict, weights: dict, seed: int,
                 prec: Precision = FP32):
        self.cfg, self.opt, self.prec = cfg, opt, prec
        self.w = weights
        self.masked = [n for n, _ in masked_weights(cfg)]
        self.rate = cfg["masker"]["zero_rate"]
        self.scores, self.thresholds = {}, {}
        for name in self.masked:
            s = weights[name].abs()
            self.scores[name] = s.clone()
            self.thresholds[name] = kth_smallest(s, int(s.numel()
                                                        * self.rate))
        self.head = {k: weights[k].clone() for k in head_params(cfg)}
        self.mu = {k: torch.zeros_like(v) for k, v in self.trainable().items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.trainable().items()}
        self.count = 0
        dev = next(iter(weights.values())).device
        self.device_gen = torch.Generator(device=dev).manual_seed(
            seed % 2 ** 64)
        self.host_gen = torch.Generator().manual_seed((seed + 1) % 2 ** 64)

    def trainable(self) -> dict[str, torch.Tensor]:
        """The stepped leaves: the LM head's and one score per masked
        weight, keyed by parameter name."""
        return dict(self.head, **self.scores)

    def params(self, grad: bool) -> tuple[dict, dict]:
        """(every parameter with each masked weight as w * [s > t], the
        leaves whose gradients are taken)."""
        p, leaves = dict(self.w), {}
        for name in self.masked:
            eff = self.w[name] * (self.scores[name]
                                  > self.thresholds[name]).float()
            p[name] = leaves[name] = eff.requires_grad_(grad)
        for k, v in self.head.items():
            p[k] = leaves[k] = v.detach().requires_grad_(grad)
        return p, leaves

    def step(self, batch: dict, block: int) -> tuple[float, dict]:
        """One training step over `batch` in blocks of `block` questions;
        returns (loss, the clipped gradient the optimizer took, by
        leaf)."""
        loss, grads = self.loss_and_grads(batch, block)
        keys = list(self.trainable())
        clip_by_global_norm([grads[k] for k in keys],
                            self.opt["max_grad_norm"])
        self._adamw(keys, grads)
        return loss, grads

    def loss_and_grads(self, batch: dict, block: int
                       ) -> tuple[float, dict]:
        """(loss, the gradient of every trainable leaf) of one training
        forward and backward over `batch`, in blocks of `block`
        questions."""
        n, a = batch["answer_ids"].shape[:2]
        draws = Replay(self.device_gen, self.host_gen)
        p, leaves = self.params(grad=True)
        loss = torch.zeros((), dtype=torch.float64,
                           device=batch["weights"].device)
        for q0 in range(0, n, block):
            q1 = min(q0 + block, n)
            blk = {k: v[q0:q1] for k, v in batch.items()}
            part = loss_sum(p, blk, self.cfg, draws.block(q0, q1, a),
                            self.prec, n) / n
            part.backward()
            loss += part.detach().double()
        grads = {}
        for k, leaf in leaves.items():
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            # the straight-through score gradient: dL/d(w*m) * w
            grads[k] = g * self.w[k] if k in self.scores else g
        return float(loss), grads

    @torch.no_grad()
    def _adamw(self, keys: list, grads: dict) -> None:
        """AdamW (Loshchilov and Hutter) with the bias-corrected moments,
        eps on their square root, the decoupled decay where it applies, in
        two groups: 'visual_encoder' leaves at lr2, the rest at lr1. The
        bias corrections 1 - b^t are formed in float32, as the reference's
        optimizer (`optax.adamw`, whose count is an int32) forms them: at
        b2 = 0.999 that is 1e-5 from the exact value in the first steps."""
        o, b1, b2, eps = self.opt, 0.9, 0.999, 1e-8
        lrs = {g: epoch_lr(self.count, o[g], o["sched"])
               for g in ("lr1", "lr2")}
        self.count += 1
        t = torch.tensor(float(self.count))
        c1, c2 = (float(1.0 - torch.tensor(b) ** t) for b in (b1, b2))
        params = self.trainable()
        for k in keys:
            g, m, v = grads[k], self.mu[k], self.nu[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / c1) / ((v / c2).sqrt() + eps)
            leaf = k.rsplit(".", 2)
            if not (leaf[-1] == "bias" or leaf[-2] == "LayerNorm"):
                u = u + o["weight_decay"] * params[k]
            lr = lrs["lr2" if k.startswith("visual_encoder.") else "lr1"]
            params[k].add_(u, alpha=-lr)

    @torch.no_grad()
    def reset(self, target: Optional[float] = None
              ) -> dict[str, torch.Tensor]:
        """Each matrix's threshold := the k-th smallest of its scores at
        `target` (the zero rate by default)."""
        rate = self.rate if target is None else target
        for name in self.masked:
            s = self.scores[name]
            self.thresholds[name] = kth_smallest(s, int(s.numel() * rate))
        return self.thresholds
