"""mPLUG (counterpart of `crvqa_tpu/models/mplug`): CLIP ViT, the BERT
text / fusion / decoder stack, the composite model and generation."""
from __future__ import annotations

from typing import Optional

import torch

from ..layers import init_weights_
from .bert import MPlugBertConfig
from .mplug import MPlug, MPlugConfig, momentum_update_
from .vit import ViTConfig, interpolate_pos_embed


def build_mplug(config: MPlugConfig, device: torch.device | str = "cpu",
                generator: Optional[torch.Generator] = None) -> MPlug:
    """The model on `device` without the default (global-RNG) init: seeded
    from `generator` (the JAX package's distributions, not its bits) when
    given, else left uninitialised for a `load_state_dict` that covers
    every parameter."""
    with torch.device("meta"):
        model = MPlug(config)
    model.to_empty(device=device)
    if generator is not None:
        init_weights_(model, generator, config.bert.initializer_range)
        model.visual_encoder.visual.reset_parameters(generator)
        with torch.no_grad():
            model.text_decoder.cls.predictions.bias.zero_()
    return model


__all__ = ["MPlug", "MPlugBertConfig", "MPlugConfig", "ViTConfig",
           "build_mplug", "interpolate_pos_embed", "momentum_update_"]
