"""LXMERT in the program (`crvqa_tpu_torch`): its config, meta model and
per-modality masker, built from a configuration file's sizes; the
benchmark's plain reference beside it."""
from __future__ import annotations

import torch

from portbench.reference import lxmert as reference

STYLE = "lxmert"  # batches carry visual_feats and visual_pos
CLASSIFIER_KEY = "classifier"

_SIZES = ("vocab_size", "hidden_size", "num_attention_heads", "l_layers",
          "r_layers", "x_layers", "intermediate_size", "hidden_dropout_prob",
          "attention_probs_dropout_prob", "classifier_dropout",
          "max_position_embeddings", "type_vocab_size", "visual_feat_dim",
          "visual_pos_dim", "ans_num")


def meta_model(cfg: dict, dtype: torch.dtype) -> torch.nn.Module:
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.train import stage2

    return stage2.lxmert_meta_model(LxmertConfig(
        dtype=dtype, **{k: cfg[k] for k in _SIZES}))


def masker(cfg: dict):
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs

    m = cfg["masker"]
    specs = lxmert_mask_specs(cfg["l_layers"], cfg["r_layers"],
                              cfg["x_layers"])
    sparsity = ModalSparsity.from_compression(
        m["comp"]["Lang"], m["comp"]["Vis"], m["comp"]["Fus"], m["zero_rate"])
    return Masker.create(specs, sparsity, threshold=m["threshold"],
                         controlled_init=m["controlled_init"],
                         binarizer_name=m["binarizer"])
