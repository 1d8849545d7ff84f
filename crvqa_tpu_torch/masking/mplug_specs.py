"""Mask specs for the mPLUG towers (a copy of
`crvqa_tpu/masking/mplug_specs.py`, the name tables and weight-type
selection of `mPLUG/masking/maskers.py:16-65` and `mPLUG/vqa_mplug.py:
99-112`):

  visual_encoder: mlp c_fc / c_proj of every ViT block
  text_encoder:   K/Q/V/AO/I/O, layers 0..5
  fusion_encoder: self + cross K/Q/V/AO + I/O, layers 6..11 (the stride
                  layers have no cross-attention, so no C* specs)
  text_decoder:   self + cross K/Q/V/AO + I/O, layers 0..11

`torch_name` is the port's module name (the reference's), `path` the JAX
package's param path (the score key). Modality is uniform ('Uni').
"""
from __future__ import annotations

from .spec import MaskSpec

_SUB = {
    "K": (("attention", "self", "key"), "attention.self.key"),
    "Q": (("attention", "self", "query"), "attention.self.query"),
    "V": (("attention", "self", "value"), "attention.self.value"),
    "AO": (("attention", "output", "dense"), "attention.output.dense"),
    "CK": (("crossattention", "self", "key"), "crossattention.self.key"),
    "CQ": (("crossattention", "self", "query"), "crossattention.self.query"),
    "CV": (("crossattention", "self", "value"), "crossattention.self.value"),
    "CAO": (("crossattention", "output", "dense"),
            "crossattention.output.dense"),
    "I": (("intermediate", "dense"), "intermediate.dense"),
    "O": (("output", "dense"), "output.dense"),
}


def _layer_spec(prefix_path, prefix_torch, layer, wt) -> MaskSpec:
    base = wt[1:] if wt.startswith("S") else wt  # SK -> K; CK stays
    sub_path, sub_torch = _SUB[base]
    return MaskSpec(path=prefix_path + (f"layer_{layer}",) + sub_path
                    + ("kernel",),
                    torch_name=f"{prefix_torch}.layer.{layer}.{sub_torch}",
                    weight_type=wt, modality="Uni")


def mplug_mask_specs(vit_layers: int = 12, text_encoder_layers: int = 6,
                     fusion_layers: int = 6, decoder_layers: int = 12,
                     stride_layer: int = 3,
                     mask_classifier: bool = False) -> list[MaskSpec]:
    specs: list[MaskSpec] = []
    for l in range(vit_layers):
        for name, wt in (("c_fc", "I_visual"), ("c_proj", "O_visual")):
            specs.append(MaskSpec(
                path=("visual_encoder", f"resblocks_{l}", f"mlp_{name}",
                      "kernel"),
                torch_name=(f"visual_encoder.visual.transformer.resblocks."
                            f"{l}.mlp.{name}"),
                weight_type=wt, modality="Uni"))
    for l in range(text_encoder_layers):
        for wt in ("K", "Q", "V", "AO", "I", "O"):
            specs.append(_layer_spec(("text_encoder",),
                                     "text_encoder.encoder", l, wt))
    for rel in range(fusion_layers):
        l = text_encoder_layers + rel
        wts = ["SK", "SQ", "SV", "SAO", "I", "O"]
        if not (rel != 0 and rel % stride_layer == 0):
            wts += ["CK", "CQ", "CV", "CAO"]
        for wt in wts:
            specs.append(_layer_spec(("fusion_encoder",),
                                     "fusion_encoder.encoder", l, wt))
    for l in range(decoder_layers):
        for wt in ("SK", "SQ", "SV", "SAO", "CK", "CQ", "CV", "CAO", "I",
                   "O"):
            specs.append(_layer_spec(("text_decoder",),
                                     "text_decoder.bert.encoder", l, wt))
    if mask_classifier:
        # the reference's `mask_classifier` adds the MOMENTUM twin's LM-head
        # transform dense only (vqa_mplug.py:116-117)
        specs.append(MaskSpec(
            path=("text_decoder", "predictions_transform_dense", "kernel"),
            torch_name="text_decoder_m.cls.predictions.transform.dense",
            weight_type="classifier", modality="Uni", momentum_only=True))
    return specs
