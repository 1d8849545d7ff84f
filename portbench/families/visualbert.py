"""VisualBERT in the program (`crvqa_tpu_torch`): its config, meta model
and uniform masker, built from a configuration file's sizes; the
benchmark's plain reference beside it."""
from __future__ import annotations

import torch

from portbench.reference import visualbert as reference

STYLE = "visualbert"  # batches carry visual_embeds
CLASSIFIER_KEY = "cls"

_SIZES = ("vocab_size", "hidden_size", "num_hidden_layers",
          "num_attention_heads", "intermediate_size", "hidden_dropout_prob",
          "attention_probs_dropout_prob", "classifier_dropout",
          "max_position_embeddings", "type_vocab_size",
          "visual_embedding_dim", "ans_num", "layer_norm_eps")


def meta_model(cfg: dict, dtype: torch.dtype) -> torch.nn.Module:
    from crvqa_tpu_torch.models import VisualBertConfig
    from crvqa_tpu_torch.train import stage2

    return stage2.visualbert_meta_model(VisualBertConfig(
        dtype=dtype, **{k: cfg[k] for k in _SIZES}))


def masker(cfg: dict):
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import visualbert_mask_specs

    m = cfg["masker"]
    return Masker.create(visualbert_mask_specs(cfg["num_hidden_layers"]),
                         ModalSparsity.uniform(m["zero_rate"]),
                         threshold=m["threshold"],
                         controlled_init=m["controlled_init"],
                         binarizer_name=m["binarizer"])
