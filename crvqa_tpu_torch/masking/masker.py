"""The functional masker (counterpart of `crvqa_tpu/masking/masker.py`).

Mask scores live in a flat dict keyed by `MaskSpec.key` (the JAX
package's keys, so the two can be compared entry by entry), each in the
TORCH weight layout `[out, in]` (an embedding's `[vocab, hidden]`): the
layout of the port's state_dict and of `mask.pt`. A train step builds the
masked weights `w * binarize(s, t)` with `apply_masks` and runs the model
on them through `torch.func.functional_call`, the counterpart of the JAX
merge into the frozen param tree. Gradients reach the scores through the
straight-through binarizer (`binarizers.py`).

Parameters are addressed by state_dict name: `<spec.torch_name>.weight`
and, with `mask_biases`, `<spec.torch_name>.bias`. A stacked spec (the
scan layout, `models/lxmert_scan.py`) names its group's stacked weight
[L, out, in] (`lxmert.encoder.layers_l.body.attention.self.query.weight`)
and carries one threshold per layer, [L]: every k-th value, init and
report is the one each layer's own matrix gets in the unrolled layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..ops.kthvalue import kth_smallest, kth_smallest_rows, sparsity_threshold
from .binarizers import get_binarizer
from .prune import prune_state_dict
from .spec import MaskSpec

Scores = dict[str, torch.Tensor]
Thresholds = dict[str, torch.Tensor]


def weight_name(spec: MaskSpec) -> str:
    """The masked weight's state_dict name. A momentum-only spec names the
    twin's module (`text_decoder_m.`); its scores come from the live
    module's weight, as the JAX package reads them from the live path. A
    stacked spec names its group's stacked weight, by its JAX path."""
    if spec.stacked:
        return ".".join(spec.path[:-1]) + ".weight"
    if spec.momentum_only:
        tower, rest = spec.torch_name.split(".", 1)
        return f"{tower.removesuffix('_m')}.{rest}.weight"
    return f"{spec.torch_name}.weight"


def bias_name(spec: MaskSpec) -> str:
    """The state_dict name of the bias beside `weight_name(spec)`."""
    return weight_name(spec)[:-len("weight")] + "bias"


def bias_key(spec: MaskSpec) -> str:
    """Score key of a spec's bias mask (the JAX package's key)."""
    return "/".join(spec.path[:-1] + ("bias",))


def layer_thresholds(spec: MaskSpec, t: torch.Tensor, ndim: int
                     ) -> torch.Tensor:
    """A stacked spec's [L] thresholds shaped to broadcast over its [L,
    ...] scores; an unstacked spec's threshold as it is. Another number
    of thresholds than L raises TypeError, where the JAX package's
    reshape raises it (`_bthr`, crvqa_tpu/masking/masker.py:39-46): a
    structured gate's single threshold over a stacked group."""
    if not spec.stacked:
        return t
    if t.numel() != spec.stacked:
        raise TypeError(
            f"{spec.key}: {tuple(t.shape)} threshold for a stacked spec of "
            f"{spec.stacked} layers (structured gates over the scan layout "
            "fail here in the JAX package too)")
    return t.reshape((spec.stacked,) + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class Masker:
    """Static mask configuration + functions over (params, scores). Args
    mirror the reference's Masker ctor (`maskers_Robust.py:491-513`); see
    the JAX package's `Masker` for each one's provenance."""

    specs: tuple[MaskSpec, ...]
    zerorate: tuple[tuple[str, float], ...]
    threshold: float = 1e-2
    init_scale: float = 2e-2
    controlled_init: Optional[str] = "magnitude"
    binarizer_name: str = "MaskedLinear1"
    global_prune: bool = False
    mask_biases: bool = False

    @classmethod
    def create(cls, specs: Sequence[MaskSpec], zerorate, **kw) -> "Masker":
        if hasattr(zerorate, "as_dict"):
            zerorate = zerorate.as_dict()
        m = cls(specs=tuple(specs), zerorate=tuple(sorted(zerorate.items())),
                **kw)
        if m.global_prune or m.controlled_init == "magnitude_global":
            # the reference's global maskers carry ONE zero rate
            if len(set(dict(m.zerorate).values())) > 1:
                raise ValueError(
                    "global pruning needs a single zero rate; got per-"
                    f"modality rates {dict(m.zerorate)} — use "
                    "ModalSparsity.uniform")
        return m

    @property
    def zerorate_dict(self) -> dict[str, float]:
        return dict(self.zerorate)

    def spec_sparsity(self, spec: MaskSpec) -> float:
        return self.zerorate_dict[spec.modality]

    # -------------------------------------------------------------------- init
    def init(self, params: dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> tuple[Scores, Thresholds]:
        """(scores, thresholds) from the frozen weights
        (`MaskedLinearX.controlled_init`, maskers_Robust.py:212-280):
        'magnitude' sets 2*threshold where |w| exceeds its per-matrix k-th
        value and 0 elsewhere, so the initial zero rate equals the
        per-modality target; the random inits draw from `generator`."""
        scores: Scores = {}
        thresholds: Thresholds = {}
        thr = self.threshold
        global_thr = None
        if self.controlled_init == "magnitude_global":
            all_abs = torch.cat([params[weight_name(s)].abs().reshape(-1)
                                 for s in self.specs])
            sp = next(iter(self.zerorate_dict.values()))
            global_thr = kth_smallest(all_abs, max(int(all_abs.numel() * sp),
                                                   1))
        for spec in self.specs:
            w = params[weight_name(spec)]
            key = spec.key
            if spec.stacked:
                scores[key], thresholds[key] = self._stacked_init(
                    spec, w, generator)
                continue
            if self.controlled_init == "magnitude_soft":
                # mPLUG variant: scores := |w|, threshold := kth(|w|)
                scores[key] = w.abs().float()
                k = max(int(w.numel() * self.spec_sparsity(spec)), 1)
                thresholds[key] = kth_smallest(scores[key], k).float()
                continue
            scores[key] = self._controlled_scores(
                w, self.spec_sparsity(spec), generator, global_thr)
            thresholds[key] = torch.tensor(thr, dtype=torch.float32,
                                           device=w.device)
        if self.mask_biases:
            # the same controlled init on each module's bias; embeddings
            # carry none (maskers_Robust.py:193-199)
            for spec in self.specs:
                if spec.stacked:
                    raise NotImplementedError(
                        "mask_biases with stacked (scan-layout) specs")
                b = params.get(bias_name(spec))
                if spec.is_embedding or b is None:
                    continue
                scores[bias_key(spec)] = self._controlled_scores(
                    b, self.spec_sparsity(spec), generator, global_thr)
        return scores, thresholds

    def _stacked_init(self, spec: MaskSpec, w: torch.Tensor,
                      generator: Optional[torch.Generator]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores, [L] thresholds) of a stacked weight, layer by layer as
        the unrolled init sets each matrix: magnitude, magnitude_soft or
        the random init (the stacked branch of crvqa_tpu/masking/
        masker.py:152-173; other inits raise there too)."""
        thr = self.threshold
        k = max(int(w[0].numel() * self.spec_sparsity(spec)), 1)
        full = torch.full((spec.stacked,), thr, dtype=torch.float32,
                          device=w.device)
        init = self.controlled_init
        if init == "magnitude":
            kth = layer_thresholds(spec, kth_smallest_rows(w.abs(), k),
                                   w.dim())
            return torch.where(w.abs() > kth, 2.0 * thr, 0.0).float(), full
        if init == "magnitude_soft":
            scores = w.abs().float()
            return scores, kth_smallest_rows(scores, k).float()
        if init is None:
            return self._controlled_scores(
                w, self.spec_sparsity(spec), generator), full
        raise NotImplementedError(
            f"controlled_init={init!r} with stacked specs")

    def _controlled_scores(self, x: torch.Tensor, sp: float,
                           generator: Optional[torch.Generator],
                           global_thr=None) -> torch.Tensor:
        """controlled_init on one tensor (maskers_Robust.py:212-280)."""
        thr = self.threshold
        n = x.numel()
        k = max(int(n * sp), 1)
        init = self.controlled_init
        f32 = dict(dtype=torch.float32, device=x.device)
        if init is None:
            # uniform in (-init_scale, hi) so the expected initial zero rate
            # matches (get_init_scales, maskers_Robust.py:282-294)
            hi = (self.init_scale + thr) / sp - self.init_scale
            return torch.empty(x.shape, **f32).uniform_(
                -self.init_scale, hi, generator=generator)
        if init == "magnitude":
            kth = kth_smallest(x.abs(), k)
            return torch.where(x.abs() > kth, 2.0 * thr, 0.0).float()
        if init == "magnitude_global":
            return torch.where(x.abs() > global_thr, 2.0 * thr, 0.0).float()
        if init == "magnitude_soft":
            return x.abs().float()
        if init == "uniform":
            # k zeros without replacement (maskers_Robust.py:230-240)
            perm = torch.randperm(n, generator=generator, device="cpu")
            flat = torch.where(perm < k, 0.0, 2.0 * thr)
            return flat.reshape(x.shape).to(**f32)
        if init == "double_uniform":
            # k indices WITH replacement below the threshold, in
            # (0.5t, 0.9t); the others in (1.1t, 1.5t) (:242-257)
            idx = torch.randint(0, n, (k,), generator=generator,
                                device="cpu")
            keep = torch.ones(n, dtype=torch.bool)
            keep[idx] = False
            above = torch.empty(n).uniform_(1.1 * thr, 1.5 * thr,
                                            generator=generator)
            below = torch.empty(n).uniform_(0.5 * thr, 0.9 * thr,
                                            generator=generator)
            return torch.where(keep, above, below).reshape(x.shape).to(**f32)
        raise NotImplementedError(f"controlled_init={init!r} not supported")

    # ------------------------------------------------------------------- apply
    def apply_masks(self, params: dict[str, torch.Tensor], scores: Scores,
                    thresholds: Thresholds,
                    generator: Optional[torch.Generator] = None,
                    momentum_tree: bool = False
                    ) -> dict[str, torch.Tensor]:
        """A copy of `params` with each masked weight replaced by
        `w * binarize(s, t)` (and, with `mask_biases`, each masked bias by
        `b * binarize(s_b, t)`: the MODULE's weight threshold, as
        maskers_Robust.py:360-367). Differentiable in the scores.
        `momentum_tree`: `params` are the distillation twins (held under
        the live names), so specs marked `momentum_only` apply too (mPLUG's
        `--mask_classifier`)."""
        binarize = get_binarizer(self.binarizer_name, generator)
        out = dict(params)
        for spec in self.specs:
            if spec.momentum_only and not momentum_tree:
                continue
            name = weight_name(spec)
            w = params[name]
            t = layer_thresholds(spec, thresholds[spec.key], w.dim())
            out[name] = w * binarize(scores[spec.key], t).to(w.dtype)
            bk = bias_key(spec)
            bname = bias_name(spec)
            if self.mask_biases and bk in scores and bname in params:
                b = params[bname]
                out[bname] = b * binarize(scores[bk], t).to(b.dtype)
        return out

    # --------------------------------------------------------------- threshold
    @torch.no_grad()
    def reset_thresholds(self, scores: Scores,
                         sparsity_override: Optional[float] = None
                         ) -> Thresholds:
        """Each module's threshold := the k-th value of its scores at its
        modality's target (`Trainer.reset_threshold`,
        mask_trainer_Robust_VQA.py:467-482); with `global_prune` one k-th
        value over all scores (`global_mask_trainer_VQA`). A stacked spec
        takes one k-th value per layer, in one batched call."""
        if self.global_prune:
            all_scores = torch.cat([scores[s.key].reshape(-1)
                                    for s in self.specs])
            sp = (sparsity_override if sparsity_override is not None
                  else next(iter(self.zerorate_dict.values())))
            t = sparsity_threshold(all_scores, sp).float()
            return {s.key: t.expand(s.stacked).clone() if s.stacked else t
                    for s in self.specs}
        out: Thresholds = {}
        for s in self.specs:
            sp = (sparsity_override if sparsity_override is not None
                  else self.spec_sparsity(s))
            sc = scores[s.key]
            out[s.key] = (kth_smallest_rows(
                sc, max(int(sc[0].numel() * sp), 1)) if s.stacked
                else sparsity_threshold(sc, sp)).float()
        return out

    # ----------------------------------------------------------------- reports
    @torch.no_grad()
    def binary_masks(self, scores: Scores, thresholds: Thresholds
                     ) -> dict[str, torch.Tensor]:
        """Bool masks keyed by spec key (True = kept weight), torch layout."""
        return {s.key: scores[s.key] > layer_thresholds(
                    s, thresholds[s.key], scores[s.key].dim())
                for s in self.specs}

    @torch.no_grad()
    def sparsity_report(self, scores: Scores, thresholds: Thresholds
                        ) -> dict[str, float]:
        """Per-modality and overall achieved zero rates
        (`save_model_mask`'s audit, mask_trainer_Robust_VQA.py:979-989)."""
        zeros: dict[str, torch.Tensor] = {}
        elems: dict[str, int] = {}
        for s in self.specs:
            z = (scores[s.key] <= layer_thresholds(
                s, thresholds[s.key], scores[s.key].dim())).sum()
            n = scores[s.key].numel()
            for m in (s.modality, "all"):
                zeros[m] = zeros.get(m, 0) + z
                elems[m] = elems.get(m, 0) + n
        return {m: float(zeros[m]) / elems[m] for m in zeros}

    def prune_params(self, params: dict[str, torch.Tensor],
                     masks: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
        """Permanently zero the masked weights (stage 3's
        `pruning_model_with_mask`, run_vqa_stage3.py:227-324): `w * mask`
        for every spec, masks keyed by weight name as `mask.pt` keys them."""
        return prune_state_dict(params, {weight_name(s): masks[weight_name(s)]
                                         for s in self.specs})

    @torch.no_grad()
    def mask_drift(self, scores: Scores, thresholds: Thresholds,
                   ref_masks: dict[str, torch.Tensor]) -> float:
        """Fraction of mask entries that differ from `ref_masks`
        (`log_mask_info`, mask_trainer_Robust_VQA.py:457-465)."""
        changed = 0
        total = 0
        for s in self.specs:
            cur = scores[s.key] > layer_thresholds(s, thresholds[s.key],
                                                   scores[s.key].dim())
            changed = changed + (cur != ref_masks[s.key]).sum()
            total += cur.numel()
        return float(changed) / total


@torch.no_grad()
def magnitude_masks(params: dict[str, torch.Tensor], specs: Sequence[MaskSpec],
                    zerorate: dict[str, float]) -> dict[str, torch.Tensor]:
    """Per-matrix magnitude pruning over every masked weight at its
    modality's rate: keep |w| above its k-th smallest, k = max(int(n *
    rate), 1) (`magnitude_masks`, crvqa_tpu/masking/masker.py:397; the
    stage-3 `--rand_scope all` baseline), per layer for a stacked spec.
    Bool masks by weight name."""
    masks = {}
    for spec in specs:
        w = params[weight_name(spec)].abs()
        rate = zerorate[spec.modality]
        if spec.stacked:
            kth = layer_thresholds(spec, kth_smallest_rows(
                w, max(int(w[0].numel() * rate), 1)), w.dim())
        else:
            kth = kth_smallest(w, max(int(w.numel() * rate), 1))
        masks[weight_name(spec)] = w > kth
    return masks


# substrings of spec.torch_name covered by the reference's mag_pruning
# module list (run_vqa_stage3.py:209-226): the 9 language layers, the
# pooler and the word embeddings; r_layers, x_layers and visn_fc are never
# magnitude-pruned by it
_REFERENCE_RAND_SCOPE = (".encoder.layer.", ".pooler.dense",
                         ".embeddings.word_embeddings")


@torch.no_grad()
def reference_rand_masks(params: dict[str, torch.Tensor],
                         specs: Sequence[MaskSpec], zero_rate: float
                         ) -> dict[str, torch.Tensor]:
    """The stage-3 `FT_randMask` baseline as the reference ships it
    (`mag_pruning`, run_vqa_stage3.py:209-226; `reference_rand_masks`,
    crvqa_tpu/masking/masker.py:425): l1 pruning of round(zero_rate * n)
    entries of each language-layer, pooler and word-embedding weight, kept
    strictly above the k-th |w| (the JAX package's tie rule); every other
    masked weight gets an all-ones mask. Bool masks by weight name."""
    masks = {}
    for spec in specs:
        w = params[weight_name(spec)].abs()
        k = int(round(zero_rate * w.numel()))
        if k <= 0 or not any(s in spec.torch_name
                             for s in _REFERENCE_RAND_SCOPE):
            masks[weight_name(spec)] = torch.ones(w.shape, dtype=torch.bool,
                                                  device=w.device)
            continue
        masks[weight_name(spec)] = w > kth_smallest(w, k)
    return masks
