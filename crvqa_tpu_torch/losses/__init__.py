"""Debias losses (counterpart of `crvqa_tpu/losses`)."""
from .vqa_losses import (LOSS_NAMES, cosine_rep_loss, dispatch_loss,
                         learned_mixin_init)

__all__ = ["LOSS_NAMES", "cosine_rep_loss", "dispatch_loss",
           "learned_mixin_init"]
