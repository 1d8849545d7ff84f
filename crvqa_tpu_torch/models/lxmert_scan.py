"""LXMERT in the scan layout (counterpart of
`crvqa_tpu/models/lxmert_scan.py`): each homogeneous layer group keeps
its parameters stacked along a leading [L] axis.

The JAX package runs each group as one `nn.scan` body to cut the TPU
compile time. Torch compiles nothing, so the layout here serves the
`--scan_layers` runs and their files: the training state of such a run
holds stacked weights, scores, moments and [L] thresholds, as the JAX
scan state does, and resumes from either package's checkpoint of it.

Parameter names follow the JAX paths: `lxmert.encoder.layers_l.body.
attention.self.query.weight` [L, out, in] stacks `lxmert.encoder.layer.
<i>.attention.self.query.weight` over the 9 language layers (`layers_r`
the 5 visual ones, `layers_x` the 5 cross ones); everything outside the
groups keeps the unrolled name. `stack_params` / `unstack_params` convert
between the layouts.

The forward runs the unrolled model's own layer modules: each layer is
the group's `body` called through `functional_call` on the i-th views of
the stacked tensors (`unbind`: no copy, and its backward stacks the
layers' gradients without a sum). So the attention takes the same
kernels with the same launches as the unrolled model, the dropout
generators draw in the same order, and the outputs and gradients are the
unrolled model's bit for bit.
"""
from __future__ import annotations

from typing import Iterator

import torch
from torch import nn
from torch.func import functional_call

from .layers import TransformerLayer
from .lxmert import (LxmertConfig, LxmertForVQA, LxmertVisualFeatureEncoder,
                     LxmertXLayer)

PREFIX = "lxmert.encoder."
# unrolled group name -> scan group name
SCAN_GROUPS = {"layer": "layers_l", "r_layers": "layers_r",
               "x_layers": "layers_x"}


def _group_lengths(config: LxmertConfig) -> dict[str, int]:
    return {"layer": config.l_layers, "r_layers": config.r_layers,
            "x_layers": config.x_layers}


class StackedLayers(nn.Module):
    """One layer group: `body`, a layer module whose every parameter
    carries a leading [length] axis."""

    def __init__(self, body: nn.Module, length: int):
        super().__init__()
        for module in body.modules():
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, nn.Parameter(
                    p.new_empty((length,) + tuple(p.shape)),
                    requires_grad=p.requires_grad))
        self.body = body
        self.length = length

    def layers(self) -> Iterator[dict[str, torch.Tensor]]:
        """Each layer's parameters: the i-th views of the stacked tensors
        (those `functional_call` substituted)."""
        views = {n: t.unbind(0) for n, t in self.body.named_parameters()}
        for i in range(self.length):
            yield {n: v[i] for n, v in views.items()}


class ScanLxmertEncoder(nn.Module):
    """visn_fc -> the language group -> the visual group -> the cross
    group, each layer the group's body on its views."""

    def __init__(self, c: LxmertConfig):
        super().__init__()
        if c.lang_num_heads is not None or c.lang_intermediate_size is not None:
            raise ValueError(
                "compaction overrides (lang_num_heads / "
                "lang_intermediate_size) are a feature of the unrolled "
                "model; the scan groups are homogeneous (models.LxmertForVQA)")
        kw = dict(c.layer_kwargs(), intermediate_size=c.intermediate_size,
                  act=c.hidden_act)
        self.visn_fc = LxmertVisualFeatureEncoder(c)
        self.layers_l = StackedLayers(TransformerLayer(**kw), c.l_layers)
        self.layers_r = StackedLayers(TransformerLayer(**kw), c.r_layers)
        self.layers_x = StackedLayers(LxmertXLayer(c), c.x_layers)

    def forward(self, lang, lang_bias, visual_feats, visual_pos,
                visn_bias=None, collect_hidden=False):
        """`collect_hidden`: the unrolled encoder's hidden-state list too
        (`LxmertEncoder.forward`)."""
        visn = self.visn_fc(visual_feats, visual_pos)
        hidden = [lang]
        for p in self.layers_l.layers():
            lang = functional_call(self.layers_l.body, p, (lang, lang_bias))
            hidden.append(lang)
        for p in self.layers_r.layers():
            visn = functional_call(self.layers_r.body, p, (visn, visn_bias))
        for p in self.layers_x.layers():
            lang, visn = functional_call(self.layers_x.body, p,
                                         (lang, lang_bias, visn, visn_bias))
            hidden.append(lang)
        return (lang, visn, hidden) if collect_hidden else (lang, visn)


class ScanLxmertForVQA(LxmertForVQA):
    """`LxmertForVQA` with the scan layout's encoder; the same inputs and
    outputs. Build it on the meta device and run it through
    `functional_call` on a stacked parameter dict (`stack_params`)."""

    def __init__(self, config: LxmertConfig):
        super().__init__(config, ScanLxmertEncoder)


def stack_params(unrolled: dict[str, torch.Tensor], config: LxmertConfig
                 ) -> dict[str, torch.Tensor]:
    """An unrolled state_dict -> the scan layout: each group's per-layer
    entries stacked along a new leading axis, in the place of the group's
    first layer; every other entry as it is (`stack_params`,
    crvqa_tpu/models/lxmert_scan.py:174-197)."""
    lengths = _group_lengths(config)
    out: dict[str, object] = {}
    layers: dict[str, dict[int, torch.Tensor]] = {}
    for name, t in unrolled.items():
        group, _, rest = name[len(PREFIX):].partition(".")
        idx, _, leaf = rest.partition(".")
        if (name.startswith(PREFIX) and group in lengths and idx.isdigit()):
            key = f"{PREFIX}{SCAN_GROUPS[group]}.body.{leaf}"
            out.setdefault(key, None)
            layers.setdefault(key, {})[int(idx)] = t
            continue
        out[name] = t
    for key, by_layer in layers.items():
        group = next(g for g, s in SCAN_GROUPS.items()
                     if key.startswith(f"{PREFIX}{s}."))
        if sorted(by_layer) != list(range(lengths[group])):
            raise KeyError(f"{key}: layers {sorted(by_layer)}, the config "
                           f"has {lengths[group]}")
        out[key] = torch.stack([by_layer[i] for i in range(lengths[group])])
    return out


def unstack_params(scanned: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """The scan layout -> an unrolled state_dict (each layer a copy), in
    the unrolled model's order within each group (`unstack_params`,
    crvqa_tpu/models/lxmert_scan.py:200-218)."""
    unrolled_of = {s: g for g, s in SCAN_GROUPS.items()}
    out: dict[str, torch.Tensor] = {}
    groups: dict[str, list[tuple[str, torch.Tensor]]] = {}
    for name, t in scanned.items():
        group, _, rest = name[len(PREFIX):].partition(".")
        body, _, leaf = rest.partition(".")
        if name.startswith(PREFIX) and group in unrolled_of and body == "body":
            if group not in groups:
                groups[group] = []
                out[group] = None  # the group's place in the order
            groups[group].append((leaf, t))
            continue
        out[name] = t
    result: dict[str, torch.Tensor] = {}
    for name, t in out.items():
        if name not in groups:
            result[name] = t
            continue
        leaves = groups[name]
        for i in range(leaves[0][1].shape[0]):
            for leaf, t in leaves:
                result[f"{PREFIX}{unrolled_of[name]}.{i}.{leaf}"] = (
                    t[i].clone())
    return result
