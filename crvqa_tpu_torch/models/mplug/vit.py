"""CLIP vision transformer for mPLUG (counterpart of
`crvqa_tpu/models/mplug/vit.py`; the reference's
`mPLUG/models/clip/model.py:VisualTransformer` with `skip_last_layer=True`).

Patch embed -> [class; patches] + positional embedding -> ln_pre -> pre-LN
residual blocks (fused q/k/v `in_proj`, QuickGELU MLP) -> ln_post, no
projection. ViT-B-16 at 384 px gives 577 tokens.

Names are the reference's (`visual.conv1`, `visual.transformer.resblocks.
{l}.attn.in_proj_weight`, `...mlp.c_fc`, `ln_1`/`ln_2`/`ln_pre`/`ln_post`).
CLIP's LayerNorms use torch's default eps 1e-5.

Images keep the JAX layout [B, H, W, 3] at the public entry; uint8 images
are CLIP-normalised on the device (`clip_normalize_u8`). The patch embed is
the conv as a matrix product over [B, grid, grid, 3*P*P] patches (the same
function as a stride-P convolution, without cuDNN and its TF32 default).

The self-attention dispatches as the JAX block's (vit.py:99-119): the
mid-length kernel when H*S > 1024 and `midseq_attention.supported` admits
the shape (ViT-B-16: S = 577), else the eager path (short contexts of small
configurations never take the short kernel here). `use_checkpoint`
recomputes each residual block in the backward (`layers.checkpointed`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ...data.augment import CLIP_MEAN, CLIP_STD
from ..layers import LayerNorm, dispatch_attention, maybe_checkpointed


def clip_normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """((x / 255) - CLIP_MEAN) / CLIP_STD in fp32 for uint8 [B, H, W, 3],
    the host path's arithmetic (`data/augment._normalize_u8`)."""
    mean = torch.as_tensor(CLIP_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_res: int = 384
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    attn_dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    # activation checkpointing of every residual block in a training
    # forward (`--use_checkpoint`; the JAX config's use_remat)
    use_checkpoint: bool = False
    # False: the eager attention everywhere (the setting under AdaHessian)
    attention_kernels: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_res // self.patch_size) ** 2

    @property
    def head_size(self) -> int:
        return self.width // self.heads

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        base = dict(image_res=32, patch_size=16, width=32, layers=2, heads=4)
        base.update(kw)
        return cls(**base)

    @classmethod
    def vit_l_14(cls, image_res: int = 392, **kw) -> "ViTConfig":
        """CLIP ViT-L-14 at a multiple of 14 (see the JAX config)."""
        base = dict(image_res=image_res, patch_size=14, width=1024,
                    layers=24, heads=16)
        base.update(kw)
        return cls(**base)


class PatchEmbed(nn.Module):
    """`conv1` (bias-free, kernel = stride = P): weight [width, 3, P, P]."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.patch = c.patch_size
        self.weight = nn.Parameter(torch.empty(c.width, 3, c.patch_size,
                                               c.patch_size, dtype=c.dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, grid*grid, width], patches row-major."""
        b, h, w, _ = images.shape
        p = self.patch
        gy, gx = h // p, w // p
        x = images[:, :gy * p, :gx * p].reshape(b, gy, p, gx, p, 3)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gy * gx, 3 * p * p)
        return torch.matmul(x.to(self.weight.dtype),
                            self.weight.reshape(self.weight.shape[0], -1).t())


class ViTAttention(nn.Module):
    """torch `nn.MultiheadAttention` as CLIP uses it: one fused q/k/v
    projection (`in_proj_weight` [3W, W], `in_proj_bias`) and `out_proj`."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.num_heads, self.head_size = c.heads, c.head_size
        self.dropout_rate = c.attn_dropout
        self.kernels = c.attention_kernels
        self.generator: Optional[torch.Generator] = None
        self.seed_generator: Optional[torch.Generator] = None
        self.data_index = 0  # the kernels' row block (`set_generators`)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c.width, c.width,
                                                       dtype=c.dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * c.width,
                                                     dtype=c.dtype))
        self.out_proj = nn.Linear(c.width, c.width, dtype=c.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.chunk(3, dim=-1)  # column slices, read in place
        rate = self.dropout_rate if self.training else 0.0
        return self.out_proj(dispatch_attention(
            q, k, v, None, self.num_heads, self.head_size, rate,
            self.generator, self.seed_generator, short_kernel=False,
            kernels=self.kernels, data_index=self.data_index))


class MLP(nn.Module):
    def __init__(self, c: ViTConfig):
        super().__init__()
        self.c_fc = nn.Linear(c.width, 4 * c.width, dtype=c.dtype)
        self.c_proj = nn.Linear(4 * c.width, c.width, dtype=c.dtype)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(c.width, eps=1e-5)
        self.attn = ViTAttention(c)
        self.ln_2 = LayerNorm(c.width, eps=1e-5)
        self.mlp = MLP(c)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, c: ViTConfig):
        super().__init__()
        self.use_checkpoint = c.use_checkpoint
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(c)
                                       for _ in range(c.layers))

    def forward(self, x):
        for block in self.resblocks:
            x = maybe_checkpointed(self.use_checkpoint, block, x)
        return x


class VisionTransformer(nn.Module):
    """`VisualTransformer.forward(skip_last_layer=True)`: returns the
    [B, 1 + grid^2, width] token states in the compute dtype."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.config = c
        self.conv1 = PatchEmbed(c)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(c.num_patches + 1, c.width))
        self.ln_pre = LayerNorm(c.width, eps=1e-5)
        self.transformer = Transformer(c)
        self.ln_post = LayerNorm(c.width, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        if images.dtype == torch.uint8:
            images = clip_normalize_u8(images)
        x = self.conv1(images.to(c.dtype))
        b = x.shape[0]
        cls_tok = self.class_embedding.to(c.dtype).expand(b, 1, c.width)
        x = torch.cat([cls_tok, x], dim=1)
        x = x + self.positional_embedding[: x.shape[1]].to(c.dtype)
        x = self.ln_pre(x)
        return self.ln_post(self.transformer(x))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions for the parameters
        `layers.init_weights_` does not cover: class and positional
        embeddings N(0, width^-1/2), the patch embed and the fused q/k/v
        projection lecun-normal (truncated), zero in_proj bias."""
        c = self.config
        for p in (self.class_embedding, self.positional_embedding):
            p.copy_(torch.empty(p.shape).normal_(0.0, c.width ** -0.5,
                                                 generator=generator))
        fan_ins = [(self.conv1.weight, 3 * c.patch_size ** 2)]
        fan_ins += [(blk.attn.in_proj_weight, c.width)
                    for blk in self.transformer.resblocks]
        for w, fan_in in fan_ins:
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            t = torch.empty(w.shape)
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            w.copy_(t)
        for blk in self.transformer.resblocks:
            blk.attn.in_proj_bias.zero_()



def interpolate_pos_embed(pos: torch.Tensor, new_num_patches: int
                          ) -> torch.Tensor:
    """The ViT's [1 + G*G, W] position embedding resized to a grid of
    `new_num_patches` (the JAX package's `interpolate_pos_embed`:
    `models/visual_transformers.py:resize_pos_embed`, `models/vit.py:
    interpolate_pos_embed`): the class row kept, the grid resized
    bicubically with `jax.image.resize`'s kernel (Keys, a = -0.5, half-pixel
    centres, the taps inside the grid renormalised, widened when it
    shrinks), which is torch's antialiased bicubic."""
    cls, grid = pos[:1], pos[1:]
    old = int(grid.shape[0] ** 0.5)
    new = int(new_num_patches ** 0.5)
    if old == new:
        return pos
    g = grid.reshape(old, old, -1).permute(2, 0, 1)[None].float()
    g = nn.functional.interpolate(g, size=(new, new), mode="bicubic",
                                  align_corners=False, antialias=True)
    g = g[0].permute(1, 2, 0).reshape(new * new, -1).to(pos.dtype)
    return torch.cat([cls, g], dim=0)

class VisualEncoder(nn.Module):
    """`visual_encoder` of the reference: the CLIP model's `visual` tower."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.visual = VisionTransformer(c)

    def forward(self, images):
        return self.visual(images)
