"""Which weights a mask covers, and their modality (mPLUG's table is
`mplug_specs.py`).

A copy of the LXMERT and VisualBERT tables of `crvqa_tpu/masking/spec.py`
(itself the name tables of the reference's `masking/maskers_Robust.py:
24-95` and `masking/maskers_visualBert.py:24-95`), and of its stacked
table for the scan layout (`lxmert_scan_mask_specs`). The port
reads `mask.pt` by `torch_name`, its own parameter names; `path` keeps the
JAX package's param path so the two tables can be compared line by line.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """One masked weight matrix."""

    path: tuple[str, ...]  # JAX param path, ending in 'kernel'/'embedding'
    torch_name: str  # e.g. 'lxmert.encoder.x_layers.3.visual_attention.att.query'
    weight_type: str  # abbrev like 'lK', 'vlVQ', 'E', 'P'
    modality: str  # 'Lang' | 'Vis' | 'Fus' | 'P' | 'Uni'
    is_embedding: bool = False
    # >0: the weight carries a leading layer axis of this length (the scan
    # layout, `models/lxmert_scan.py`); torch_name is then a '{}' template
    # over the layer index
    stacked: int = 0
    # masks only the momentum twin (mPLUG's `mask_classifier` quirk):
    # `apply_masks` skips it on the live parameters
    momentum_only: bool = False

    @property
    def key(self) -> str:
        return "/".join(self.path)


# weight-type -> (subpath function, modality, torch name, is_embedding)
_LXMERT_TYPES: dict[str, tuple] = {
    "E": (lambda l: ("embeddings", "word_embeddings"), "Lang", "embeddings.word_embeddings", True),
    "VV": (lambda l: ("encoder", "visn_fc", "visn_fc"), "Vis", "encoder.visn_fc.visn_fc", False),
    "VB": (lambda l: ("encoder", "visn_fc", "box_fc"), "Vis", "encoder.visn_fc.box_fc", False),
}
_LXMERT_LAYER_TYPES: dict[str, tuple[str, tuple[str, ...], str]] = {
    # abbrev: (torch layer-group, submodule path, modality)
    "lK": ("layer", ("attention", "self", "key"), "Lang"),
    "lQ": ("layer", ("attention", "self", "query"), "Lang"),
    "lV": ("layer", ("attention", "self", "value"), "Lang"),
    "lAO": ("layer", ("attention", "output", "dense"), "Lang"),
    "lI": ("layer", ("intermediate", "dense"), "Lang"),
    "lO": ("layer", ("output", "dense"), "Lang"),
    "vK": ("r_layers", ("attention", "self", "key"), "Vis"),
    "vQ": ("r_layers", ("attention", "self", "query"), "Vis"),
    "vV": ("r_layers", ("attention", "self", "value"), "Vis"),
    "vAO": ("r_layers", ("attention", "output", "dense"), "Vis"),
    "vI": ("r_layers", ("intermediate", "dense"), "Vis"),
    "vO": ("r_layers", ("output", "dense"), "Vis"),
    "vlVK": ("x_layers", ("visual_attention", "att", "key"), "Fus"),
    "vlVQ": ("x_layers", ("visual_attention", "att", "query"), "Fus"),
    "vlVV": ("x_layers", ("visual_attention", "att", "value"), "Fus"),
    "vlVAO": ("x_layers", ("visual_attention", "output", "dense"), "Fus"),
    "vlLaK": ("x_layers", ("lang_self_att", "self", "key"), "Fus"),
    "vlLaQ": ("x_layers", ("lang_self_att", "self", "query"), "Fus"),
    "vlLaV": ("x_layers", ("lang_self_att", "self", "value"), "Fus"),
    "vlLaAO": ("x_layers", ("lang_self_att", "output", "dense"), "Fus"),
    "vlVaK": ("x_layers", ("visn_self_att", "self", "key"), "Fus"),
    "vlVaQ": ("x_layers", ("visn_self_att", "self", "query"), "Fus"),
    "vlVaV": ("x_layers", ("visn_self_att", "self", "value"), "Fus"),
    "vlVaAO": ("x_layers", ("visn_self_att", "output", "dense"), "Fus"),
    "vlLi": ("x_layers", ("lang_inter", "dense"), "Fus"),
    "vlLo": ("x_layers", ("lang_output", "dense"), "Fus"),
    "vlVi": ("x_layers", ("visn_inter", "dense"), "Fus"),
    "vlVo": ("x_layers", ("visn_output", "dense"), "Fus"),
}

LXMERT_WEIGHT_TYPES: tuple[str, ...] = (
    "E", "VV", "VB",
    "lK", "lQ", "lV", "lAO", "lI", "lO",
    "vK", "vQ", "vV", "vAO", "vI", "vO",
    "vlVK", "vlVQ", "vlVV", "vlVAO",
    "vlLaK", "vlLaQ", "vlLaV", "vlLaAO",
    "vlVaK", "vlVaQ", "vlVaV", "vlVaAO",
    "vlLi", "vlLo", "vlVi", "vlVo",
    "P",
)


def lxmert_mask_specs(
    l_layers: int = 9,
    r_layers: int = 5,
    x_layers: int = 5,
    weight_types: Sequence[str] = LXMERT_WEIGHT_TYPES,
    ptl: str = "lxmert",
    layers_to_mask: Optional[Sequence[int]] = None,
) -> list[MaskSpec]:
    """Every masked LXMERT weight (`chain_module_names`,
    `prune_debias_VQA.py:300-310`), `layers_to_mask` (default: all)
    intersected with each group's real layer count."""
    layer_counts = {"layer": l_layers, "r_layers": r_layers, "x_layers": x_layers}
    allowed = set(layers_to_mask) if layers_to_mask is not None else None
    specs: list[MaskSpec] = []
    for wt in weight_types:
        if wt in _LXMERT_TYPES:
            subpath_fn, modality, tname, is_emb = _LXMERT_TYPES[wt]
            specs.append(
                MaskSpec(
                    path=(ptl,) + subpath_fn(None) + (("embedding",) if is_emb else ("kernel",)),
                    torch_name=f"{ptl}.{tname}",
                    weight_type=wt,
                    modality=modality,
                    is_embedding=is_emb,
                )
            )
        elif wt == "P":
            specs.append(
                MaskSpec(
                    path=(ptl, "pooler", "dense", "kernel"),
                    torch_name=f"{ptl}.pooler.dense",
                    weight_type="P",
                    modality="P",
                )
            )
        else:
            group, subpath, modality = _LXMERT_LAYER_TYPES[wt]
            for l in range(layer_counts[group]):
                if allowed is not None and l not in allowed:
                    continue
                specs.append(
                    MaskSpec(
                        path=(ptl, "encoder", f"{group}_{l}") + subpath + ("kernel",),
                        torch_name=f"{ptl}.encoder.{group}.{l}." + ".".join(subpath),
                        weight_type=wt,
                        modality=modality,
                    )
                )
    return specs


# VisualBERT: uniform sparsity over a single-stream BERT stack
# (maskers_visualBert.py:24-36: K/Q/V/AO/I/O/P/E, all of modality 'Uni').
_VISUALBERT_LAYER_TYPES: dict[str, tuple[str, ...]] = {
    "K": ("attention", "self", "key"),
    "Q": ("attention", "self", "query"),
    "V": ("attention", "self", "value"),
    "AO": ("attention", "output", "dense"),
    "I": ("intermediate", "dense"),
    "O": ("output", "dense"),
}

# The shipped driver's selection (prune_debias_VQA_visualBERT.py:145); the
# masker's full table also has 'VP', the visual projection
# (maskers_visualBert.py:24-36).
VISUALBERT_WEIGHT_TYPES: tuple[str, ...] = ("K", "Q", "V", "AO", "I", "O",
                                            "P", "E")
VISUALBERT_ALL_WEIGHT_TYPES: tuple[str, ...] = VISUALBERT_WEIGHT_TYPES + (
    "VP",)


def visualbert_mask_specs(
    num_layers: int = 12,
    weight_types: Sequence[str] = VISUALBERT_WEIGHT_TYPES,
    ptl: str = "visual_bert",
) -> list[MaskSpec]:
    """Every masked VisualBERT weight, all under modality 'Uni': 74 at 12
    layers with the shipped selection."""
    singles = {
        "E": (("embeddings", "word_embeddings", "embedding"),
              "embeddings.word_embeddings", True),
        "P": (("pooler", "dense", "kernel"), "pooler.dense", False),
        "VP": (("embeddings", "visual_projection", "kernel"),
               "embeddings.visual_projection", False),
    }
    specs: list[MaskSpec] = []
    for wt in weight_types:
        if wt in singles:
            subpath, tname, is_emb = singles[wt]
            specs.append(MaskSpec(path=(ptl,) + subpath,
                                  torch_name=f"{ptl}.{tname}",
                                  weight_type=wt, modality="Uni",
                                  is_embedding=is_emb))
            continue
        subpath = _VISUALBERT_LAYER_TYPES[wt]
        for l in range(num_layers):
            specs.append(MaskSpec(
                path=(ptl, "encoder", f"layer_{l}") + subpath + ("kernel",),
                torch_name=f"{ptl}.encoder.layer.{l}." + ".".join(subpath),
                weight_type=wt, modality="Uni"))
    return specs



def specs_by_modality(specs: Sequence[MaskSpec]
                      ) -> dict[str, list[MaskSpec]]:
    """The specs grouped by modality, in first-seen order (the JAX
    package's `specs_by_modality`)."""
    out: dict[str, list[MaskSpec]] = {}
    for s in specs:
        out.setdefault(s.modality, []).append(s)
    return out

def lxmert_scan_mask_specs(
    l_layers: int = 9,
    r_layers: int = 5,
    x_layers: int = 5,
    ptl: str = "lxmert",
) -> list[MaskSpec]:
    """The masked weights of the scan layout (`models/lxmert_scan.py`):
    one stacked spec per weight type and layer group, its weight [L, out,
    in], plus E, VV, VB and P unstacked (`lxmert_scan_mask_specs`,
    crvqa_tpu/masking/spec.py:224-255). Every layer is masked. The order
    of the per-layer names (`torch_name.format(i)`) is `lxmert_mask_specs`'
    order, so both layouts export the same mask.pt."""
    specs: list[MaskSpec] = []
    for wt in ("E", "VV", "VB"):
        subpath_fn, modality, tname, is_emb = _LXMERT_TYPES[wt]
        specs.append(MaskSpec(
            path=(ptl,) + subpath_fn(None) + (("embedding",) if is_emb
                                              else ("kernel",)),
            torch_name=f"{ptl}.{tname}", weight_type=wt, modality=modality,
            is_embedding=is_emb))
    group_info = {"layer": ("layers_l", l_layers),
                  "r_layers": ("layers_r", r_layers),
                  "x_layers": ("layers_x", x_layers)}
    for wt, (group, subpath, modality) in _LXMERT_LAYER_TYPES.items():
        scan_name, length = group_info[group]
        specs.append(MaskSpec(
            path=(ptl, "encoder", scan_name, "body") + subpath + ("kernel",),
            torch_name=f"{ptl}.encoder.{group}.{{}}." + ".".join(subpath),
            weight_type=wt, modality=modality, stacked=length))
    specs.append(MaskSpec(
        path=(ptl, "pooler", "dense", "kernel"),
        torch_name=f"{ptl}.pooler.dense", weight_type="P", modality="P"))
    return specs
