"""Debias losses (counterpart of `crvqa_tpu/losses/vqa_losses.py`): pure
functions (logits, hidden, bias, labels) -> scalar, the formulas of the
reference's `hg_transformers/vqa_debias_loss_functions.py` (Plain,
BiasProduct, ReweightByInvBias, LearnedMixin) and the LPF / RUBI losses of
`mask_trainer_Robust_VQA.py:161-186`, in fp32.

LearnedMixin's parameters are a dict in the torch layout:
`{"bias_lin.weight": [1, hidden], "bias_lin.bias": [1], "smooth_param":
[1]}` (the reference's `nn.Linear(hidden, 1)` and its smoothing scalar).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- primitives

def convert_sigmoid_logits_to_binary_logprobs(logits):
    """log(sigmoid(l)), log(1 - sigmoid(l))."""
    log_prob = -F.softplus(-logits)
    return log_prob, -logits + log_prob


def elementwise_logsumexp(a, b):
    """log(exp(a) + exp(b))."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def renormalize_binary_logits(a, b):
    """Normalize so exp(a) + exp(b) == 1."""
    norm = elementwise_logsumexp(a, b)
    return a - norm, b - norm


def bce_with_logits(logits, labels):
    """Elementwise binary cross entropy with logits, the stable form."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


# -------------------------------------------------------------------- losses

def plain_bce(logits, labels):
    """Multi-label soft-score BCE, mean over elements times the answer
    count (`instance_bce_with_logits`, modeling_lxmert.py:248-253)."""
    return torch.mean(bce_with_logits(logits, labels)) * labels.shape[1]


def reweight_by_inv_bias(logits, bias, labels):
    """`ReweightByInvBias` (vqa_debias_loss_functions.py:73-80)."""
    log_prob, log_one_minus_prob = convert_sigmoid_logits_to_binary_logprobs(
        logits)
    loss = -(log_prob * labels + (1 - labels) * log_one_minus_prob)
    weights = 1 - bias
    return torch.sum(loss * weights) / torch.sum(weights)


def bias_product(logits, bias, labels,
                 smooth_param: Optional[torch.Tensor] = None,
                 constant_smooth: float = 0.0):
    """`BiasProduct` PoE (vqa_debias_loss_functions.py:83-122); `smooth_param`
    None disables the learned smoothing."""
    smooth = constant_smooth
    if smooth_param is not None:
        smooth = smooth + torch.sigmoid(smooth_param)
    bias_lp = torch.log(bias + smooth)
    bias_l_inv = torch.log1p(-bias + smooth)
    log_prob, log_one_minus_prob = convert_sigmoid_logits_to_binary_logprobs(
        logits)
    log_prob, log_one_minus_prob = renormalize_binary_logits(
        log_prob + bias_lp, log_one_minus_prob + bias_l_inv)
    return -torch.mean(torch.sum(
        log_prob * labels + (1 - labels) * log_one_minus_prob, dim=1))


def learned_mixin_init(generator: Optional[torch.Generator],
                       hidden_size: int = 768, smooth_init: float = -1.0,
                       device="cpu") -> dict[str, torch.Tensor]:
    """`LearnedMixin.__init__` (vqa_debias_loss_functions.py:125-146):
    bias_lin = nn.Linear(hidden, 1) with torch's default uniform(+-1/sqrt(
    hidden)) weight and bias, and the smoothing scalar at -1."""
    bound = 1.0 / math.sqrt(hidden_size)
    w = torch.empty(1, hidden_size).uniform_(-bound, bound,
                                             generator=generator)
    b = torch.empty(1).uniform_(-bound, bound, generator=generator)
    return {"bias_lin.weight": w.to(device), "bias_lin.bias": b.to(device),
            "smooth_param": torch.full((1,), smooth_init, device=device)}


def learned_mixin(params: dict[str, torch.Tensor], hidden, logits, bias,
                  labels, w: float = 0.36, constant_smooth: float = 0.0,
                  smooth: bool = True):
    """`LearnedMixin(+H)` (vqa_debias_loss_functions.py:148-196), w = 0.36
    as every trainer instantiates it (mask_trainer_Robust_VQA.py:248)."""
    factor = F.linear(hidden, params["bias_lin.weight"],
                      params["bias_lin.bias"])
    factor = F.softplus(factor)                              # [batch, 1]
    bias2 = torch.stack([bias, 1 - bias], dim=2) + constant_smooth
    if smooth:
        bias2 = bias2 + torch.sigmoid(params["smooth_param"])[None, :]
    bias2 = torch.log(bias2) * factor[:, :, None]

    log_prob, log_one_minus_prob = convert_sigmoid_logits_to_binary_logprobs(
        logits)
    fused = bias2 + torch.stack([log_prob, log_one_minus_prob], dim=2)
    log_prob, log_one_minus_prob = renormalize_binary_logits(
        fused[:, :, 0], fused[:, :, 1])

    sum_prob = torch.sum(log_prob * labels + (1 - labels) * log_one_minus_prob,
                         dim=1)
    sum_prob = torch.where(torch.isnan(sum_prob), torch.zeros_like(sum_prob),
                           sum_prob)                         # NaN guard (:183)
    loss = -torch.mean(sum_prob)

    bias_norm = elementwise_logsumexp(bias2[:, :, 0], bias2[:, :, 1])
    bias_logprob = bias2 - bias_norm[:, :, None]
    entropy = -torch.mean(torch.sum(torch.exp(bias_logprob) * bias_logprob,
                                    dim=2))
    return loss + w * entropy


def lpf_loss(logits, bias, max_label, gamma: float = 5.0):
    """LPF (mask_trainer_Robust_VQA.py:161-179): (1 - bias prob of the
    answer)^gamma * CE(logits, argmax label)."""
    vqa_pt = torch.clamp(torch.softmax(logits, dim=-1), min=1.0e-7)
    qo_pt = torch.clamp(bias, min=1.0e-7)
    idx = max_label.long()[:, None]
    ce = -torch.gather(torch.log(vqa_pt), 1, idx)[:, 0]
    feedback = torch.exp(torch.gather(torch.log(qo_pt), 1, idx)[:, 0])
    return torch.mean((1 - feedback) ** gamma * ce)


def rubi_loss(logits, bias, max_label):
    """RUBI (mask_trainer_Robust_VQA.py:182-186): CE(logits * sigmoid(bias),
    argmax label)."""
    logp = torch.log_softmax(logits * torch.sigmoid(bias), dim=-1)
    return torch.mean(-torch.gather(logp, 1, max_label.long()[:, None])[:, 0])


def cosine_rep_loss(student_rep, teacher_rep):
    """KD representation loss (mask_trainer_Robust_VQA.py:95-97):
    mean(1 - cos(student, teacher)), the denominator clamped at 1e-8."""
    num = torch.sum(student_rep * teacher_rep, dim=-1)
    den = (torch.linalg.norm(student_rep, dim=-1)
           * torch.linalg.norm(teacher_rep, dim=-1))
    return torch.mean(1.0 - num / torch.clamp(den, min=1e-8))


LOSS_NAMES = ("normal", "lmh", "lpf", "rubi", "poe", "reweight")


def dispatch_loss(loss_type: str, *, logits, pooled, labels, bias, max_label,
                  lmh_params: Optional[dict] = None, gamma: float = 5.0,
                  lmh_w: float = 0.36):
    """The `Masker_type` loss dispatch of `_training_step`
    (mask_trainer_Robust_VQA.py:812-831)."""
    if loss_type == "normal":
        return plain_bce(logits, labels)
    if loss_type == "lmh":
        return learned_mixin(lmh_params, pooled, logits, bias, labels,
                             w=lmh_w)
    if loss_type == "lpf":
        return lpf_loss(logits, bias, max_label, gamma=gamma)
    if loss_type == "rubi":
        return rubi_loss(logits, bias, max_label)
    if loss_type == "poe":
        smooth = lmh_params["smooth_param"] if lmh_params else None
        return bias_product(logits, bias, labels, smooth_param=smooth)
    if loss_type == "reweight":
        return reweight_by_inv_bias(logits, bias, labels)
    raise NotImplementedError(f"loss_type={loss_type!r}")
