"""Plain PyTorch pieces of the benchmark's references: products in a stated
precision, layer norm, gelu, the attention with its dropout, the hidden
dropout, the LearnedMixin loss, the clip and the stage-2 AdamW.

Everything here is written from the published equations and runs in
float32 with TF32 off (`Precision("fp32")`). The same code in
`Precision("fp8")` rounds every operand of every product to float8 with a
per-tensor scale (e4m3 for activations and weights, e5m2 for gradients),
the step that would tempt a later change: it is the control that the
output check must refuse.

Randomness is the program's contract, not its state: a training step's
hidden dropout masks are `torch.rand(shape) < 1 - rate` drawn from the
step's device generator, one full-batch draw per dropout site in the
model's order, and each attention call draws one int32 seed from the host
generator, whose keep mask is the counter hash below (the published JAX
kernels' `_keep_mask`). `Draws` replays both from the seed, so the
reference can run a batch in blocks of rows and still drop exactly what a
whole-batch step drops.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_MASK32 = 0xFFFFFFFF
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_fp32() -> None:
    """Float32 products stay float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The precision of every product: "fp32" or "fp8"."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    @property
    def fp8(self) -> bool:
        return self.name == "fp8"


FP32 = Precision("fp32")


def quantize(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to `fmt` under one per-tensor scale (its absolute maximum
    onto the format's largest value), returned in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / _FP8_MAX[fmt]
    return (x.float() / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3; the backward's products take the
    incoming gradient in e5m2 and the saved operands as rounded."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, torch.float8_e4m3fn), quantize(
            b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision = FP32
           ) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b) if prec.fp8 else a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           prec: Precision = FP32) -> torch.Tensor:
    """x @ w.T + b, w in the [out, in] layout."""
    y = matmul(x, w.t(), prec)
    return y if b is None else y + b


def layer_norm(x, w, b, eps: float = 1e-12):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu(x):
    """The exact erf gelu."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def weight_norm_linear(x, v, g, b, prec: Precision = FP32):
    """A weight-normalised Linear, W = g * V / ||V||_F (scalar g)."""
    return linear(x, v * (g / v.norm().clamp_min(1e-12)), b, prec)


def additive_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] 1/0 mask -> [B, L] additive key bias, -10000 at pads."""
    return (1.0 - mask.float()) * -10000.0


# ------------------------------------------------------------------ dropout

def keep_threshold(rate: float) -> int:
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def attention_keep(rows: torch.Tensor, sq: int, cols: int, rate: float,
                   seed: int) -> torch.Tensor:
    """Bool keep mask [len(rows), sq, cols] of the counter hash keyed on
    (seed, global batch row, query row i, column j = head * Sk + key), in
    uint32 arithmetic carried in int64."""
    dev = rows.device
    key = ((((seed & _MASK32) * 2654435761) & _MASK32)
           + rows.to(torch.int64) * 97531) & _MASK32
    i = torch.arange(sq, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    x = (i * 374761393 + j * 668265263) & _MASK32
    x = (x + key[:, None, None]) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 1274126177) & _MASK32
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


class Draws:
    """One training step's randomness, replayed from its generators.

    `hidden(x, rate, batch)` drops the block `x` (rows `rows` of a batch of
    `batch`) with the mask of the next dropout site; `attn_seed()` is the
    next attention call's seed. The first block draws each site's
    whole-batch mask when it reaches the site, in the order the sites come,
    and later blocks read the same sites in the same order. `dead_hidden`
    and `dead_attn` consume a site whose output reaches no loss.
    `None` generators (eval, or counting on `meta`) drop nothing."""

    def __init__(self, device_gen: Optional[torch.Generator],
                 host_gen: Optional[torch.Generator], rows: slice = None,
                 log: Optional[list] = None):
        self.device_gen, self.host_gen = device_gen, host_gen
        # (batch, heads, Sq, Sk, head size, with backward) of every
        # attention call, when a list is given (`counts/flops.py`)
        self.log = log
        self.masks: list[torch.Tensor] = []
        self.seeds: list[int] = []
        self.rows = rows
        self._h = self._a = 0

    @property
    def live(self) -> bool:
        return self.device_gen is not None

    def block(self, rows: slice) -> "Draws":
        """Restart the site cursors for the block of `rows`."""
        self.rows, self._h, self._a = rows, 0, 0
        return self

    def _mask(self, shape, rate: float, device) -> torch.Tensor:
        if self._h == len(self.masks):
            r = torch.rand(shape, generator=self.device_gen, device=device)
            self.masks.append(r < 1.0 - rate)
        m = self.masks[self._h]
        if tuple(m.shape) != tuple(shape):
            raise RuntimeError(f"dropout site {self._h}: {tuple(shape)} "
                               f"where the first block drew {tuple(m.shape)}")
        self._h += 1
        return m

    def hidden(self, x: torch.Tensor, rate: float, batch: int
               ) -> torch.Tensor:
        if not self.live or rate == 0.0:
            return x
        keep = self._mask((batch,) + tuple(x.shape[1:]), rate,
                          x.device)[self.rows]
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), device=x.device))

    def dead_hidden(self, shape, rate: float, device) -> None:
        if self.live and rate != 0.0:
            self._mask(shape, rate, device)

    def attn_seed(self) -> int:
        if not self.live:
            return 0
        if self._a == len(self.seeds):
            self.seeds.append(int(torch.randint(
                -2 ** 31, 2 ** 31, (), generator=self.host_gen)))
        s = self.seeds[self._a]
        self._a += 1
        return s

    dead_attn = attn_seed


# ---------------------------------------------------------------- attention

def attention(q, k, v, key_bias, heads: int, rate: float, draws: Draws,
              prec: Precision = FP32) -> torch.Tensor:
    """Multi-head softmax(q k^T / sqrt(D) + bias) with the counter-hash
    dropout on the probabilities, then @ v. q [b, Sq, H*D]; k, v [b, Sk,
    H*D]; key_bias [b, Sk] (None: no bias)."""
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // heads
    if draws.log is not None:
        draws.log.append((b, heads, sq, sk, d, q.requires_grad))
    split = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
    s = matmul(split(q), split(k).transpose(-1, -2), prec) / math.sqrt(d)
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    seed = draws.attn_seed() if rate else 0
    if draws.live and rate:
        rows = torch.arange(draws.rows.start, draws.rows.start + b,
                            device=q.device)
        keep = attention_keep(rows, sq, heads * sk, rate, seed)
        keep = keep.reshape(b, sq, heads, sk).transpose(1, 2)
        p = torch.where(keep, p / (1.0 - rate),
                        torch.zeros((), device=p.device))
    ctx = matmul(p, split(v), prec)
    return ctx.transpose(1, 2).reshape(b, sq, hd)


# ------------------------------------------------------------------- losses

def _binary_logprobs(logits):
    log_prob = -F.softplus(-logits)
    return log_prob, -logits + log_prob


def _logsumexp2(a, b):
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def learned_mixin_rows(lmh: dict, pooled, logits, bias, labels,
                       w: float = 0.36) -> torch.Tensor:
    """LearnedMixin +H (Clark et al., 2019) per row: the row's negative
    log-likelihood of its soft targets under the bias-fused binary
    probabilities (a NaN row counts 0) plus w times the row's bias entropy.
    The batch loss is the mean over rows."""
    factor = F.softplus(pooled @ lmh["bias_lin.weight"].t()
                        + lmh["bias_lin.bias"])                  # [b, 1]
    bias2 = torch.stack([bias, 1 - bias], dim=2)
    bias2 = bias2 + torch.sigmoid(lmh["smooth_param"])[None, :]
    bias2 = torch.log(bias2) * factor[:, :, None]
    lp, l1p = _binary_logprobs(logits)
    fused = bias2 + torch.stack([lp, l1p], dim=2)
    norm = _logsumexp2(fused[:, :, 0], fused[:, :, 1])
    lp, l1p = fused[:, :, 0] - norm, fused[:, :, 1] - norm
    ll = torch.sum(lp * labels + (1 - labels) * l1p, dim=1)
    ll = torch.where(torch.isnan(ll), torch.zeros_like(ll), ll)
    bnorm = _logsumexp2(bias2[:, :, 0], bias2[:, :, 1])
    blp = bias2 - bnorm[:, :, None]
    # the batch's entropy term is a mean over rows and answers: a row
    # carries the mean over its answers
    entropy = -torch.sum(torch.exp(blp) * blp, dim=2).mean(dim=1)
    return -ll + w * entropy


def learned_mixin_init(seed: int, hidden: int) -> dict:
    """LearnedMixin's parameters as its constructor draws them from a CPU
    generator seeded `seed`: nn.Linear(hidden, 1)'s uniform(+-1/sqrt(
    hidden)) weight, then its bias, and the smoothing scalar at -1."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(hidden)
    w = torch.empty(1, hidden).uniform_(-bound, bound, generator=gen)
    b = torch.empty(1).uniform_(-bound, bound, generator=gen)
    return {"bias_lin.weight": w, "bias_lin.bias": b,
            "smooth_param": torch.full((1,), -1.0)}


# ---------------------------------------------------------------- optimizer

@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> None:
    """Every gradient times max_norm / ||g|| when the global norm reaches
    max_norm."""
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).float()
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


def linear_decay(lr: float, total_steps: int, count: int) -> float:
    """The learning rate at `count` under a linear decay to 0 over
    `total_steps`, with no warm-up."""
    return lr * (1.0 - min(max(count, 0), total_steps) / total_steps)


@torch.no_grad()
def hf_adamw(params: list, grads: list, mu: list, nu: list, count: int,
             lr: float, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8) -> int:
    """The reference repo's AdamW (no weight decay): moments, then
    p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps), eps
    outside the bias correction. Returns the new count t."""
    t = count + 1
    step = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.add_(m / (v.sqrt() + eps), alpha=-step)
    return t
