"""Plain stage-2 mask training and masked answering (Compress-Robust-VQA's
`mask_trainer_Robust_VQA.py`, written from its equations).

Every masked weight w carries a real score s; the model runs on w * [s >
t]. Scores start by magnitude: 2 * 0.01 where |w| is above the matrix's
k-th smallest |w| (k = int(n * rate)), else 0, with t = 0.01. A step runs
the model in training mode, takes the LearnedMixin +H loss, passes the
gradient of each masked weight straight through the binarizer (ds = dW *
w), clips all trainable gradients (scores and the classifier) to a global
norm of 1 and steps them with the reference's AdamW. A reset sets each
matrix's t to the k-th smallest of its scores.

The whole batch is run in blocks of rows whose gradients add up, with the
dropout of a whole-batch step (`common.Draws`), so the memory of a block
bounds the reference's.
"""
from __future__ import annotations

import torch

from .common import (FP32, Draws, Precision, clip_by_global_norm, hf_adamw,
                     learned_mixin_init, learned_mixin_rows, linear_decay)


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.kthvalue(flat, min(max(int(k), 1), flat.numel())).values


def zero_rates(cfg: dict) -> dict[str, float]:
    """Each modality's target zero rate: 1 - its kept share (`masker.
    comp`), or the one rate of a uniform masker."""
    m = cfg["masker"]
    if "comp" in m:
        rates = {mod: 1.0 - c for mod, c in m["comp"].items()}
        rates["P"] = m["zero_rate"]
        return rates
    return {"Uni": m["zero_rate"]}


def sparsity_k(n: int, rate: float) -> int:
    return max(int(n * rate), 1)


class Stage2Reference:
    """The reference's training state, worked out from the weights and the
    seed alone. `weights`: every parameter by name, float32 on the device
    the reference runs on."""

    def __init__(self, family, cfg: dict, trf: dict, weights: dict,
                 seed: int, prec: Precision = FP32):
        self.family, self.cfg, self.trf, self.prec = family, cfg, trf, prec
        self.w = weights
        self.masked = family.masked_weights(cfg)
        rates = zero_rates(cfg)
        self.rate = {name: rates[mod] for name, mod in self.masked}
        thr = cfg["masker"]["threshold"]
        self.scores, self.thresholds = {}, {}
        for name, _ in self.masked:
            w = weights[name]
            kth = kth_smallest(w.abs(), sparsity_k(w.numel(),
                                                   self.rate[name]))
            self.scores[name] = torch.where(w.abs() > kth, 2.0 * thr,
                                            0.0).float()
            self.thresholds[name] = torch.tensor(thr, device=w.device)
        pre = family.CLASSIFIER + "."
        self.classifier = {k: v.clone() for k, v in weights.items()
                           if k.startswith(pre)}
        dev = next(iter(weights.values())).device
        self.lmh = {k: v.to(dev) for k, v in learned_mixin_init(
            (seed + 3) % 2 ** 64, cfg["hidden_size"]).items()}
        opt = trf["optimizer"]
        self.mu = {k: torch.zeros_like(v) for k, v in self.trainable().items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.trainable().items()}
        self.count = 0
        self.lr, self.total = opt["learning_rate"], opt["total_steps"]
        self.eps, self.max_norm = opt["adam_epsilon"], opt["max_grad_norm"]
        self.device_gen = torch.Generator(device=dev).manual_seed(
            seed % 2 ** 64)
        self.host_gen = torch.Generator().manual_seed((seed + 1) % 2 ** 64)

    def trainable(self) -> dict[str, torch.Tensor]:
        """The stepped leaves: the classifier's and one score per masked
        weight, keyed by parameter name."""
        return dict(self.classifier, **self.scores)

    def params(self, grad: bool) -> tuple[dict, dict]:
        """(every parameter with each masked weight as w * [s > t], the
        leaves whose gradients are taken)."""
        leaves = {}
        p = dict(self.w)
        for name, _ in self.masked:
            eff = self.w[name] * (self.scores[name]
                                  > self.thresholds[name]).float()
            p[name] = eff.requires_grad_(grad)
            leaves[name] = p[name]
        for k, v in self.classifier.items():
            p[k] = v.detach().requires_grad_(grad)
            leaves[k] = p[k]
        return p, leaves

    def step(self, batch: dict, block_rows: int) -> tuple[float, dict]:
        """One training step over `batch`; returns (loss, the clipped
        gradient the optimizer took, by leaf)."""
        n = batch["input_ids"].shape[0]
        draws = Draws(self.device_gen, self.host_gen)
        p, leaves = self.params(grad=True)
        loss = torch.zeros((), dtype=torch.float64,
                           device=batch["input_ids"].device)
        for r0 in range(0, n, block_rows):
            rows = slice(r0, min(r0 + block_rows, n))
            blk = {k: v[rows] for k, v in batch.items()}
            logits, pooled = self.family.forward(p, blk, self.cfg,
                                                 draws.block(rows), self.prec,
                                                 n)
            part = learned_mixin_rows(self.lmh, pooled, logits, blk["bias"],
                                      blk["labels"]).sum() / n
            part.backward()
            loss += part.detach().double()
        grads = {}
        for k, leaf in leaves.items():
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            # the straight-through score gradient: dL/d(w*m) * w
            grads[k] = g * self.w[k] if k in self.scores else g
        del p, leaves
        keys = list(self.trainable())
        clip_by_global_norm([grads[k] for k in keys], self.max_norm)
        lr = linear_decay(self.lr, self.total, self.count)
        params = self.trainable()
        self.count = hf_adamw([params[k] for k in keys],
                              [grads[k] for k in keys],
                              [self.mu[k] for k in keys],
                              [self.nu[k] for k in keys], self.count, lr,
                              eps=self.eps)
        return float(loss), grads

    @torch.no_grad()
    def reset(self) -> dict[str, torch.Tensor]:
        """Each matrix's threshold := the k-th smallest of its scores."""
        for name, _ in self.masked:
            s = self.scores[name]
            self.thresholds[name] = kth_smallest(
                s, sparsity_k(s.numel(), self.rate[name]))
        return self.thresholds

    @torch.no_grad()
    def logits(self, batch: dict, block_rows: int) -> torch.Tensor:
        """Eval-mode logits (no dropout) of every row of `batch`, in
        blocks."""
        p, _ = self.params(grad=False)
        n = batch["input_ids"].shape[0]
        out = []
        for r0 in range(0, n, block_rows):
            sl = slice(r0, min(r0 + block_rows, n))
            out.append(self.family.forward(
                p, {k: v[sl] for k, v in batch.items()}, self.cfg,
                Draws(None, None, sl), self.prec)[0])
        return torch.cat(out)


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}

