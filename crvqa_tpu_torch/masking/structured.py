"""Structured masking: one gate per attention head ("heads") or per weight
matrix ("layers") (counterpart of `crvqa_tpu/masking/structured.py`; the
reference's structured `MaskedLinearX` branches, maskers_Robust.py:
139-178, and the stage-3 head / FFN binarizers, prune_debias_VQA.py:
633-667).

Gates live in the same flat dict as unstructured scores, keyed by
`MaskSpec.key`, with reduced shapes: () for "layers", (num_heads,) for
"heads". A train step expands each binarized gate onto its weight in the
TORCH layout `[out, in]`: a head owns a block of `head_size` ROWS (the JAX
package's `[in, out]` kernels give it a block of columns).

The unstructured specs keep the base masker's semantics, the per-layer
thresholds of stacked specs (the scan layout) included. A structured gate
over a stacked spec fails as the JAX package's does: its single threshold
cannot broadcast over the group's layers (`masker.layer_thresholds`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.kthvalue import kth_smallest
from .binarizers import binarize_ste, get_binarizer
from .masker import Masker, Scores, Thresholds, layer_thresholds, weight_name
from .spec import MaskSpec


class BinarizeHeadSTE(torch.autograd.Function):
    """Zero exactly the globally lowest `num_to_mask` entries of an [L, H]
    head-score matrix, 1 elsewhere; identity gradient (`Binarizer_head`,
    prune_debias_VQA.py:633-650). By stable rank, so ties zero exactly k
    heads and num_to_mask = 0 zeroes none."""

    @staticmethod
    def forward(ctx, scores, num_to_mask):
        flat = scores.reshape(-1)
        rank = torch.argsort(torch.argsort(flat, stable=True))
        return (rank >= int(num_to_mask)).to(scores.dtype).reshape(
            scores.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None


def binarize_head_ste(scores: torch.Tensor, num_to_mask) -> torch.Tensor:
    return BinarizeHeadSTE.apply(scores, num_to_mask)


# Binarizer_ffn (prune_debias_VQA.py:652-667) is the plain threshold STE
binarize_ffn_ste = binarize_ste


def expand_head_mask_to_kernel(head_mask: torch.Tensor, weight_shape
                               ) -> torch.Tensor:
    """[num_heads] head mask -> [out, in] weight mask: head h owns rows
    h * head_size .. (h + 1) * head_size - 1 (reshape_mask_for_sp,
    maskers_Robust.py:305-320)."""
    out_dim, in_dim = weight_shape
    rows = head_mask.repeat_interleave(out_dim // head_mask.shape[-1])
    return rows[:, None].expand(out_dim, in_dim)


@dataclasses.dataclass(frozen=True)
class StructuredMasker(Masker):
    """"heads" or "layers" structured mask training. `structured_types`
    selects the structurally masked specs by substring of their JAX path
    (the reference's `structured_masking_types`); the others keep
    unstructured scores."""

    structured_masking: str = "heads"  # 'heads' | 'layers'
    structured_types: tuple[str, ...] = ("self",)
    num_heads: int = 12

    def _is_structured(self, spec: MaskSpec) -> bool:
        return any(t in ".".join(spec.path) for t in self.structured_types)

    def _unstructured(self) -> Optional[Masker]:
        """The unstructured specs as a plain masker, or None."""
        rest = tuple(s for s in self.specs if not self._is_structured(s))
        return dataclasses.replace(self, specs=rest, structured_types=()
                                   ) if rest else None

    def init(self, params: dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> tuple[Scores, Thresholds]:
        """Gates uniform in (-init_scale, init_scale) (the structured
        branch has no controlled init, maskers_Robust.py:146, 165-167);
        the unstructured specs take `Masker.init` on a stream of their
        own, seeded from `generator`."""
        if self.mask_biases:
            # the structured apply gates kernels only: bias scores would
            # train and never apply
            raise NotImplementedError(
                "mask_biases with structured masking is not supported")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        own = torch.Generator().manual_seed(int(torch.randint(
            0, 2 ** 62, (1,), generator=generator)))
        scores: Scores = {}
        thresholds: Thresholds = {}
        sub = self._unstructured()
        if sub is not None:
            scores, thresholds = Masker.init(sub, params, own)
        shape = () if self.structured_masking == "layers" else (
            self.num_heads,)
        for spec in self.specs:
            if not self._is_structured(spec):
                continue
            device = params[weight_name(spec)].device
            scores[spec.key] = torch.empty(shape).uniform_(
                -self.init_scale, self.init_scale,
                generator=generator).to(device)
            thresholds[spec.key] = torch.tensor(
                self.threshold, dtype=torch.float32, device=device)
        return scores, thresholds

    def apply_masks(self, params: dict[str, torch.Tensor], scores: Scores,
                    thresholds: Thresholds,
                    generator: Optional[torch.Generator] = None,
                    momentum_tree: bool = False
                    ) -> dict[str, torch.Tensor]:
        """`Masker.apply_masks` (the momentum_only contract included) with
        each structured gate expanded onto its weight."""
        binarize = get_binarizer(self.binarizer_name, generator)
        out = dict(params)
        for spec in self.specs:
            if spec.momentum_only and not momentum_tree:
                continue
            name = weight_name(spec)
            w = params[name]
            if self._is_structured(spec):
                m = expand_gate(binarize(scores[spec.key],
                                         thresholds[spec.key]), w.shape)
            else:
                m = binarize(scores[spec.key], layer_thresholds(
                    spec, thresholds[spec.key], w.dim()))
            out[name] = w * m.to(w.dtype)
        return out

    @torch.no_grad()
    def reset_thresholds(self, scores: Scores,
                         sparsity_override: Optional[float] = None
                         ) -> Thresholds:
        """Scalar gates keep the nominal threshold; head gates take their
        k-th smallest, k = max(int(n * sparsity), 1); the unstructured
        specs delegate (global_prune keeps its base meaning over them)."""
        sub = self._unstructured()
        out = ({} if sub is None else
               Masker.reset_thresholds(sub, scores, sparsity_override))
        for s in self.specs:
            if not self._is_structured(s):
                continue
            sc = scores[s.key]
            if sc.dim() == 0:
                out[s.key] = torch.tensor(self.threshold, dtype=torch.float32,
                                          device=sc.device)
                continue
            sp = (sparsity_override if sparsity_override is not None
                  else self.spec_sparsity(s))
            out[s.key] = kth_smallest(sc, max(int(sc.numel() * sp), 1)
                                      ).float()
        return out

    @torch.no_grad()
    def sparsity_report(self, scores: Scores, thresholds: Thresholds,
                        params: Optional[dict[str, torch.Tensor]] = None
                        ) -> dict[str, float]:
        """Achieved zero rates by modality and "all". Without `params` a
        gate counts as one entry; with them each structured gate counts
        the weight elements it controls."""
        zeros: dict[str, float] = {}
        elems: dict[str, float] = {}
        for s in self.specs:
            sc = scores[s.key]
            z = float((sc <= layer_thresholds(s, thresholds[s.key],
                                              sc.dim())).sum())
            n = float(max(sc.numel(), 1))
            if self._is_structured(s) and params is not None:
                per_gate = params[weight_name(s)].numel() / n
                z, n = z * per_gate, n * per_gate
            for m in (s.modality, "all"):
                zeros[m] = zeros.get(m, 0.0) + z
                elems[m] = elems.get(m, 0.0) + n
        return {m: zeros[m] / elems[m] for m in zeros}


def expand_gate(gate: torch.Tensor, weight_shape) -> torch.Tensor:
    """A binarized gate over its weight: a scalar ("layers") over the
    whole matrix, a head vector over its row blocks."""
    if gate.dim() == 0:
        return gate.expand(weight_shape)
    return expand_head_mask_to_kernel(gate, weight_shape)


def weight_masks(masker: Masker, masks: dict[str, torch.Tensor],
                 shapes: dict[str, torch.Size]) -> dict[str, torch.Tensor]:
    """Binary masks by spec key with every reduced gate expanded to its
    weight's shape (`shapes`, by weight name): what `mask.pt` carries."""
    out = {}
    for spec in masker.specs:
        shape = shapes[weight_name(spec)]
        m = masks[spec.key]
        out[spec.key] = m if m.shape == shape else expand_gate(m, shape)
    return out


LANG_LAYER = ".encoder.layer."


def lang_head_mask(masker: Masker, masks: dict[str, torch.Tensor],
                   l_layers: int, num_heads: int) -> Optional[np.ndarray]:
    """[l_layers, num_heads] float32 head mask of the language layers in
    the stage-3 `--head_mask_npy` format (save_struc_model_mask,
    mask_trainer_Robust_VQA.py:933-941): a head survives if any of its
    gates in a language spec survives (pruning it while a projection keeps
    it would change the forward). None when no language spec has head
    gates: an all-zero file would tell stage 3 to prune every head."""
    hm = np.zeros((l_layers, num_heads), np.float32)
    contributed = 0
    for spec in masker.specs:
        m = masks.get(spec.key)
        if (LANG_LAYER not in spec.torch_name or m is None
                or tuple(m.shape) != (num_heads,)):
            continue
        layer = int(spec.torch_name.split(LANG_LAYER)[1].split(".")[0])
        hm[layer] = np.maximum(hm[layer], m.cpu().numpy().astype(np.float32))
        contributed += 1
    return hm if contributed else None


@torch.no_grad()
def magnitude_head_scores(params: dict[str, torch.Tensor],
                          specs: Sequence[MaskSpec], num_heads: int
                          ) -> dict[str, torch.Tensor]:
    """Importance init for head gates: the L2 norm of each head's rows of
    the [out, in] weight."""
    out = {}
    for spec in specs:
        w = params[weight_name(spec)]
        out_dim, in_dim = w.shape
        per_head = w.float().reshape(num_heads, out_dim // num_heads,
                                     in_dim).norm(dim=(1, 2))
        out[spec.key] = per_head
    return out
