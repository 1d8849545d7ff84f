"""Shared building blocks (counterpart of `crvqa_tpu/models/layers.py`).

Module and parameter names are the reference PyTorch names
(`hg_transformers/modeling_lxmert.py`), so a reference state_dict, a
`mask.pt` and a `classifier4masker.bin` load directly.

Dtype policy, as in the JAX package: Linear weights live in the compute
dtype (a state_dict loaded into them is cast once), embeddings, LayerNorms
and the weight-norm classifier keep fp32 parameters; LayerNorm computes in
fp32 and returns the compute dtype; attention scores and softmax are fp32.

Randomness: a training forward draws only from explicit generators, never
from the global RNG. `set_generators(model, device_gen, seed_gen)` hands
every `Dropout` (hidden, embedding, classifier) and every attention its
device generator, and the attentions a CPU generator for the int32 seed of
the attention kernels' counter-hash dropout (one draw per call, only when
dropout is live). Eval draws nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attention import MAX_HEADS_TIMES_SEQ, fused_attention
from ..ops.midseq_attention import midseq_attention
from ..ops.midseq_attention import supported as midseq_supported
from ..ops.residual_layernorm import residual_layernorm

# Bidirectional cross attention in one pass (`LxmertXLayer`): project q, k
# and v and run the output block ONCE over the [lang; visn] concatenation
# instead of calling the shared `visual_attention` twice; the same
# parameters and the same two attention calls, lang first. Read at call
# time (`JOINT_CROSS_ATTENTION` of crvqa_tpu/models/layers.py).
JOINT_CROSS_ATTENTION = False


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf gelu in fp32 (the reference's F.gelu); the tanh form in
    bf16, as the JAX package does (`crvqa_tpu/models/layers.py:17-36`: its
    error vs erf is below bf16 rounding of the FFN activations)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


ACT2FN = {"gelu": gelu, "relu": F.relu, "tanh": torch.tanh}


def _need_generator(gen: Optional[torch.Generator], what: str
                    ) -> torch.Generator:
    if gen is None:
        raise RuntimeError(
            f"{what}: dropout in training mode draws from an explicit "
            "generator; call models.layers.set_generators(model, ...) first")
    return gen


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn from `generator` (on x's
    device): where(keep, x / (1 - rate), 0), as flax's nn.Dropout."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=_need_generator(generator,
                                                         "dropout"),
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dropout(nn.Module):
    """`nn.Dropout` drawing from an explicit generator (`set_generators`);
    the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, self.generator)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-12) with fp32 parameters and fp32 statistics that
    returns its input's dtype (flax LayerNorm with dtype=bf16)."""

    def __init__(self, hidden_size: int, eps: float = 1e-12):
        super().__init__(hidden_size, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class WeightNormDense(nn.Module):
    """Linear with torch-style weight normalisation, dim=None (scalar g):
    W = g * V / ||V||_F (`SimpleClassifier`'s `weight_norm(nn.Linear)`).

    Own `weight_v` [out, in] / `weight_g` [] / `bias` parameters — the
    reference state_dict keys — rather than `torch.nn.utils.weight_norm`,
    whose parametrization renames them. W is formed in fp32 and cast to the
    input's dtype."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_g = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.in_features)
        v = torch.empty(self.weight_v.shape).uniform_(-bound, bound,
                                                      generator=generator)
        b = torch.empty(self.bias.shape).uniform_(-bound, bound,
                                                  generator=generator)
        with torch.no_grad():
            self.weight_v.copy_(v)
            self.weight_g.copy_(v.norm())
            self.bias.copy_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_v * (self.weight_g
                             / self.weight_v.norm().clamp_min(1e-12))
        return F.linear(x, w.to(x.dtype), self.bias.to(x.dtype))


class PadFrozenEmbed(nn.Embedding):
    """`nn.Embedding(padding_idx=0)`: an ordinary gather whose pad row gets
    no gradient — the reference builds word, position and token-type
    embeddings this way (`modeling_lxmert.py:734-736`)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__(num_embeddings, embedding_dim, padding_idx=0)


def kernel_seed(rate: float, seed_generator: Optional[torch.Generator],
                what: str) -> int:
    """The attention kernels' int32 dropout seed: one draw per call from
    the module's CPU seed generator, only when dropout is live."""
    if rate == 0.0:
        return 0
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=_need_generator(
        seed_generator, what)))


def dispatch_attention(q, k, v, attention_bias, num_heads: int,
                       head_size: int, rate: float,
                       generator: Optional[torch.Generator],
                       seed_generator: Optional[torch.Generator],
                       short_kernel: bool = True,
                       kernels: bool = True,
                       data_index: int = 0, head0: int = 0) -> torch.Tensor:
    """Attention on flat [B, S, H*D] projections, dispatched as the JAX
    package's `MultiHeadAttention._attend` (crvqa_tpu/models/layers.py:
    255-307) dispatches when its kernels are on:

    - a key-wise bias (None or [B, 1, 1, Sk]) with H*Sq and H*Sk <= 1024
      -> `fused_attention` (only with `short_kernel`; the ViT's short
      contexts stay eager, as in crvqa_tpu/models/mplug/vit.py:99-112);
    - a key-wise bias past that bound that `midseq_attention.supported`
      admits -> `midseq_attention`;
    - anything else (a causal [B, 1, L, L] bias, shapes out of scope) ->
      the eager path, the counterpart of the XLA einsums.

    `kernels=False` takes the eager path for every shape: the model's
    setting under a second-order optimizer, whose double backward the
    kernels' autograd Functions do not have (the JAX package turns its
    kernels off there too, crvqa_tpu/cli/common.py:289-302).

    `data_index`: this rank's place on a data-parallel mesh. Every data
    rank holds an equal block of the global batch, so the kernels key
    their dropout masks on global row data_index * B + b and each rank
    draws its block of the one-device run's mask. `head0`: the first of
    this rank's heads under tensor parallelism, for the same reason."""
    if not kernels:
        return eager_attention(q, k, v, attention_bias, num_heads,
                               head_size, rate, generator)
    keywise = attention_bias is None or (
        attention_bias.dim() == 4 and attention_bias.shape[1] == 1
        and attention_bias.shape[2] == 1)
    short = (k.shape[1] * num_heads <= MAX_HEADS_TIMES_SEQ
             and q.shape[1] * num_heads <= MAX_HEADS_TIMES_SEQ)
    if keywise and (short and short_kernel or not short and midseq_supported(
            q.shape[0], q.shape[1], k.shape[1], num_heads, head_size,
            q.element_size())):
        if attention_bias is None:
            bias2d = torch.zeros(q.shape[0], k.shape[1], dtype=torch.float32,
                                 device=q.device)
        else:
            bias2d = attention_bias[:, 0, 0, :].float()
        kernel = fused_attention if short else midseq_attention
        seed = kernel_seed(rate, seed_generator, "attention kernel")
        return kernel(q, k, v, bias2d, num_heads, head_size, rate, seed,
                      row0=data_index * q.shape[0], head0=head0)
    return eager_attention(q, k, v, attention_bias, num_heads, head_size,
                           rate, generator)


def eager_attention(q, k, v, attention_bias, num_heads: int, head_size: int,
                    rate: float, generator: Optional[torch.Generator]
                    ) -> torch.Tensor:
    """Attention for contexts out of the kernels' scope, on flat
    [B, S, H*D] projections: scores as the product in the activation dtype,
    then fp32 bias and softmax, probabilities in the activation dtype (the
    JAX package's `_attend_heads` einsum path)."""
    b, sq, d = q.shape
    split = lambda t: t.reshape(b, t.shape[1], num_heads,
                                head_size).transpose(1, 2)
    scores = torch.matmul(split(q), split(k).transpose(-1, -2)).float()
    scores = scores / math.sqrt(head_size)
    if attention_bias is not None:
        scores = scores + attention_bias.float()
    probs = dropout(torch.softmax(scores, dim=-1).to(q.dtype), rate,
                    generator)
    ctx = torch.matmul(probs, split(v))
    return ctx.transpose(1, 2).reshape(b, sq, d)


class MultiHeadAttention(nn.Module):
    """`LxmertAttention` over an explicit context (self- or cross-attention):
    query/key/value Linear, additive key bias, fp32 softmax, dispatched to
    the attention kernels by `dispatch_attention`.

    Two more entries, for autoregressive decoding (the JAX module's `kv`
    and `self_cache`; crvqa_tpu/models/layers.py:222-249), both on the
    eager path as in the JAX package:

    - `kv`: precomputed (k, v) projections of the context, each
      [B, S, H, D] (the decoder's cached cross-attention memory);
    - `self_cache` / `cache_position`: `hidden`/`context` is the one new
      row [N, 1, hidden]; its k and v are written into the caches
      [N, max_len, H, D] at `cache_position` (in place) and the row attends
      the whole cache under the caller's key bias. Returns (out, caches).

    And one for LXMERT's bidirectional cross attention
    (`JOINT_CROSS_ATTENTION`): `joint_split` s and `joint_biases`
    (lang_bias, visn_bias), `hidden` the [lang; visn] concatenation and
    `context` unused: q, k and v are projected once over it, rows [:s]
    attend keys [s:] under visn_bias and rows [s:] keys [:s] under
    lang_bias. The attention calls take the projections' row slices as
    views (their batch and row strides go to the kernels; a slice starts
    on a whole row, so the bf16 kernels' 16-byte staging holds)."""

    def __init__(self, hidden_size: int, num_heads: int, head_size: int,
                 dropout_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 kernels: bool = True):
        super().__init__()
        d = num_heads * head_size
        self.num_heads, self.head_size = num_heads, head_size
        self.dropout_rate = dropout_rate
        self.kernels = kernels  # False: always the eager path
        self.generator: Optional[torch.Generator] = None       # masks
        self.seed_generator: Optional[torch.Generator] = None  # kernel seeds
        self.data_index = 0  # the kernels' row block (`set_generators`)
        # tensor parallelism (`parallel.tp.enable_tp`): this rank's heads
        # from head0, f at the inputs of the projections
        self.tp = None
        self.head0 = 0
        self.query = nn.Linear(hidden_size, d, dtype=dtype)
        self.key = nn.Linear(hidden_size, d, dtype=dtype)
        self.value = nn.Linear(hidden_size, d, dtype=dtype)

    def forward(self, hidden: torch.Tensor, context: Optional[torch.Tensor],
                attention_bias: Optional[torch.Tensor] = None, kv=None,
                self_cache=None, cache_position: Optional[int] = None,
                joint_split: Optional[int] = None, joint_biases=None):
        if self.tp is not None:
            same = context is hidden or context is None
            hidden = self.tp.copy_to_model(hidden)
            context = hidden if same else self.tp.copy_to_model(context)
        q = self.query(hidden)
        if joint_split is not None:
            s = joint_split
            k, v = self.key(hidden), self.value(hidden)
            lang_bias, visn_bias = joint_biases
            ctx_l = self._attend(q[:, :s], k[:, s:], v[:, s:], visn_bias)
            ctx_v = self._attend(q[:, s:], k[:, :s], v[:, :s], lang_bias)
            return torch.cat([ctx_l, ctx_v], dim=1)
        rate = self.dropout_rate if self.training else 0.0
        if self_cache is not None:
            k_cache, v_cache = self_cache
            n, _, h, d = k_cache.shape
            k_cache[:, cache_position] = self.key(context)[:, 0].reshape(
                n, h, d).to(k_cache.dtype)
            v_cache[:, cache_position] = self.value(context)[:, 0].reshape(
                n, h, d).to(v_cache.dtype)
            out = eager_attention(q, k_cache.flatten(2), v_cache.flatten(2),
                                  attention_bias, self.num_heads,
                                  self.head_size, rate, self.generator)
            return out, (k_cache, v_cache)
        if kv is not None:
            k, v = kv
            return eager_attention(q, k.flatten(2), v.flatten(2),
                                   attention_bias, self.num_heads,
                                   self.head_size, rate, self.generator)
        return self._attend(q, self.key(context), self.value(context),
                            attention_bias)

    def _attend(self, q, k, v, attention_bias):
        rate = self.dropout_rate if self.training else 0.0
        return dispatch_attention(q, k, v, attention_bias, self.num_heads,
                                  self.head_size, rate, self.generator,
                                  self.seed_generator, kernels=self.kernels,
                                  data_index=self.data_index,
                                  head0=self.head0)


def row_parallel(dense: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """`dense(x)`; under tensor parallelism (`tp`) the local product of a
    row-parallel dense summed over the model group (g), then its
    replicated bias, added once."""
    if tp is None:
        return dense(x)
    return tp.reduce_from_model(F.linear(x, dense.weight)) + dense.bias


class _OutputBlock(nn.Module):
    """dense -> dropout -> residual add -> LayerNorm, the closing block of
    every attention and FFN sublayer. The epilogue after the dense is
    `ops/residual_layernorm.py`: one kernel pair on the card, the eager
    chain on the CPU and with `kernels=False` (the model's setting under a
    second-order optimizer, as for the attentions). Under tensor
    parallelism the dense is row-parallel (`row_parallel`)."""

    def __init__(self, in_size: int, hidden_size: int, dropout_rate: float,
                 dtype: torch.dtype, kernels: bool):
        super().__init__()
        self.dense = nn.Linear(in_size, hidden_size, dtype=dtype)
        self.dropout = Dropout(dropout_rate)
        self.LayerNorm = LayerNorm(hidden_size)
        self.kernels = kernels
        self.tp = None

    def forward(self, hidden, residual):
        y = row_parallel(self.dense, hidden, self.tp)
        rate = self.dropout.rate if self.dropout.training else 0.0
        generator = (_need_generator(self.dropout.generator, "dropout")
                     if rate else None)
        ln = self.LayerNorm
        return residual_layernorm(y, residual, ln.weight, ln.bias, ln.eps,
                                  rate, generator, kernels=self.kernels)


class AttentionOutput(_OutputBlock):
    """`LxmertAttentionOutput`. `in_size` is the attention's width, heads x
    head size: the hidden size unless the heads were compacted
    (`masking/compaction.py`)."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 in_size: Optional[int] = None, kernels: bool = True):
        super().__init__(in_size or hidden_size, hidden_size, dropout_rate,
                         dtype, kernels)


class SelfAttentionLayer(nn.Module):
    """`LxmertSelfAttentionLayer`: attention (named `self`) + output."""

    def __init__(self, num_heads: int, head_size: int, hidden_size: int,
                 attn_dropout: float = 0.1, hidden_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self = MultiHeadAttention(hidden_size, num_heads, head_size,
                                       attn_dropout, dtype)
        self.output = AttentionOutput(hidden_size, hidden_dropout, dtype,
                                      num_heads * head_size)

    def forward(self, x, attention_bias=None):
        return self.output(self.self(x, x, attention_bias), x)


class CrossAttentionLayer(nn.Module):
    """`LxmertCrossAttentionLayer`: attention (named `att`) + output. In
    joint mode (`joint_split`, see `MultiHeadAttention`) `x` is the
    [lang; visn] concatenation and the output block runs once over it (its
    ops act row by row)."""

    def __init__(self, num_heads: int, head_size: int, hidden_size: int,
                 attn_dropout: float = 0.1, hidden_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att = MultiHeadAttention(hidden_size, num_heads, head_size,
                                      attn_dropout, dtype)
        self.output = AttentionOutput(hidden_size, hidden_dropout, dtype,
                                      num_heads * head_size)

    def forward(self, x, context, ctx_attention_bias=None, joint_split=None,
                joint_biases=None):
        return self.output(self.att(x, context, ctx_attention_bias,
                                    joint_split=joint_split,
                                    joint_biases=joint_biases), x)


class Intermediate(nn.Module):
    """`LxmertIntermediate`: dense -> activation (column-parallel under
    tensor parallelism: f at its input)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 act: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size, dtype=dtype)
        self.act = ACT2FN[act]
        self.tp = None

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.copy_to_model(x)
        return self.act(self.dense(x))


class FFNOutput(_OutputBlock):
    """`LxmertOutput`: the FFN's output block."""

    def __init__(self, intermediate_size: int, hidden_size: int,
                 dropout_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 kernels: bool = True):
        super().__init__(intermediate_size, hidden_size, dropout_rate, dtype,
                         kernels)


class TransformerLayer(nn.Module):
    """Self-attention + FFN block (`LxmertLayer`, a BERT layer)."""

    def __init__(self, num_heads: int, head_size: int, hidden_size: int,
                 intermediate_size: int, act: str = "gelu",
                 attn_dropout: float = 0.1, hidden_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = SelfAttentionLayer(num_heads, head_size, hidden_size,
                                            attn_dropout, hidden_dropout,
                                            dtype)
        self.intermediate = Intermediate(hidden_size, intermediate_size, act,
                                         dtype)
        self.output = FFNOutput(intermediate_size, hidden_size,
                                hidden_dropout, dtype)

    def forward(self, x, attention_bias=None):
        att = self.attention(x, attention_bias)
        return self.output(self.intermediate(att), att)


def extend_attention_mask(mask: Optional[torch.Tensor]
                          ) -> Optional[torch.Tensor]:
    """[B, L] 1/0 mask -> additive [B, 1, 1, L] fp32 bias, -10000 at pads
    (`LxmertModel.forward`, modeling_lxmert.py:1386-1402)."""
    if mask is None:
        return None
    return ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


def set_generators(model: nn.Module, device_generator: torch.Generator,
                   seed_generator: torch.Generator, data_index: int = 0
                   ) -> None:
    """Give every dropout of `model` its generators: `device_generator` (on
    the model's device) for dropout masks, `seed_generator` (CPU) for the
    attention kernels' per-call seeds; `data_index` is this rank's place on
    a data-parallel mesh, the row block of the kernels' masks
    (`dispatch_attention`)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = device_generator
        elif hasattr(m, "seed_generator"):  # every attention module
            m.generator = device_generator
            m.seed_generator = seed_generator
            m.data_index = data_index


def _generators(module: nn.Module) -> list[torch.Generator]:
    """The distinct generators `set_generators` handed to `module`'s
    dropouts and attentions."""
    found: dict[int, torch.Generator] = {}
    for m in module.modules():
        for g in (getattr(m, "generator", None),
                  getattr(m, "seed_generator", None)):
            if g is not None:
                found.setdefault(id(g), g)
    return list(found.values())


def checkpointed(module: nn.Module, *args, **kwargs):
    """module(*args, **kwargs) under activation checkpointing
    (`torch.utils.checkpoint`, non-reentrant): the block's activations are
    dropped after the forward and recomputed in the backward.

    The recompute replays the forward's randomness exactly, as flax's
    `nn.remat` replays its dropout key: every generator of the block (the
    dropout masks' and the attention kernels' seed draws; checkpoint itself
    restores only the global RNGs, which the port never draws from) is set
    back to its state at the forward before the recompute and returned to
    where it was after it. The block's parameters are captured at the
    forward and laid over it again for the recompute, which runs after the
    caller's `functional_call` has restored the module's own (meta)
    tensors."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    gens = _generators(module)
    saved = [g.get_state() for g in gens]
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    calls = []

    def run(*a, **kw):
        if not calls:
            calls.append(1)
            return module(*a, **kw)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, saved):
            g.set_state(state)
        try:
            return functional_call(module, tensors, a, kw)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


def maybe_checkpointed(enabled: bool, module: nn.Module, *args, **kwargs):
    """`checkpointed` when `enabled` and gradients are being recorded (a
    training forward), else a plain call: without a backward there is
    nothing to recompute. On `meta` tensors a plain call too: they only
    count the model's work (`utils/mfu.count_flops`), and a recompute is
    not the model's."""
    on_meta = any(isinstance(a, torch.Tensor) and a.device.type == "meta"
                  for a in args)
    if enabled and torch.is_grad_enabled() and not on_meta:
        return checkpointed(module, *args, **kwargs)
    return module(*args, **kwargs)


def init_weights_(module: nn.Module, generator: torch.Generator,
                  initializer_range: float = 0.02) -> None:
    """Seeded init matching the JAX package's distributions (not its bits):
    Linear weights lecun-normal truncated at two standard deviations
    (flax's Dense default) with zero bias, embeddings N(0, 0.02),
    LayerNorm ones/zeros, weight-norm layers uniform(+-1/sqrt(in)) with
    g = ||V||. Works on modules built on the meta device after
    `to_empty`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                # flax truncated_normal variance scaling: std corrected for
                # the truncation at +-2
                std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, initializer_range, generator=generator)
                m.weight.copy_(w)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WeightNormDense):
                m.reset_parameters(generator)
