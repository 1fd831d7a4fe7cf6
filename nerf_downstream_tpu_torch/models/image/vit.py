"""Vision Transformers: ViT and DeiT3 patch16-224 variants (counterpart
of ``nerf_downstream_tpu/models/image/vit.py``), NCHW input, built to
flax's semantics.

- Attention as flax's ``MultiHeadDotProductAttention`` computes it: q, k,
  v and the output projection in flax's ``[dim, heads, head_dim]`` and
  ``[heads, head_dim, dim]`` layouts, the query scaled by
  ``1/sqrt(head_dim)``, explicit products and a softmax in the compute
  type.
- The residual stream is f32 (flax promotes the bf16 patch embedding to
  f32 when it adds the f32 position embedding); each block's LayerNorm
  (epsilon 1e-6), attention and MLP compute in ``dtype``; the head in f32.
- ``MlpBlock`` uses the exact (erf) GELU.
- The position embedding is sized for ``image_size`` (flax sizes it from
  the first batch; the configs' crops are 224).
- DeiT3 = ViT + LayerScale (``layer_scale``) on each residual branch, and
  ``no_embed_class``: the position embedding covers the patch tokens only
  and is added before the class token is prepended.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.models.image.layers import (
    Conv2d,
    Dense,
    LayerNorm,
)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense((dim,), (hidden,), dtype)
        self.fc2 = Dense((hidden,), (dim,), dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        hd = dim // heads
        self.heads, self.head_dim, self.dtype = heads, hd, dtype
        self.query = Dense((dim,), (heads, hd), dtype)
        self.key = Dense((dim,), (heads, hd), dtype)
        self.value = Dense((dim,), (heads, hd), dtype)
        self.out = Dense((heads, hd), (dim,), dtype)

    def forward(self, x):
        # [B, T, H, hd] -> [B, H, T, hd]
        q = self.query(x).transpose(1, 2)
        k = self.key(x).transpose(1, 2)
        v = self.value(x).transpose(1, 2)
        q = q / math.sqrt(self.head_dim)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((w @ v).transpose(1, 2))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 layer_scale: float | None = None, dtype=torch.float32):
        super().__init__()
        self.layer_scale = layer_scale
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, heads, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype)
        if layer_scale is not None:
            self.ls1 = nn.Parameter(torch.full((dim,), float(layer_scale)))
            self.ls2 = nn.Parameter(torch.full((dim,), float(layer_scale)))

    def reset_parameters(self, gen):
        if self.layer_scale is not None:
            with torch.no_grad():
                self.ls1.fill_(float(self.layer_scale))
                self.ls2.fill_(float(self.layer_scale))

    def forward(self, x):
        y = self.attn(self.norm1(x))
        x = x + (y * self.ls1 if self.layer_scale is not None else y)
        y = self.mlp(self.norm2(x))
        return x + (y * self.ls2 if self.layer_scale is not None else y)


class ViT(nn.Module):
    flax_paths = "image"  # convert.flax_layout

    # backbone params sit at the module root; only the head is fresh
    pretrained_submodule = None

    def __init__(self, num_classes: int = 51, dim: int = 384, depth: int = 12,
                 heads: int = 6, patch: int = 16,
                 layer_scale: float | None = None,
                 no_embed_class: bool = False, dtype=torch.float32,
                 pretrained: bool = False, pretrained_arch: str = "",
                 image_size: int = 224):
        super().__init__()
        self.dim, self.patch, self.dtype = dim, patch, dtype
        self.no_embed_class = no_embed_class
        self.pretrained, self.pretrained_arch = pretrained, pretrained_arch
        self.patch_embed = Conv2d(3, dim, patch, patch, bias=True,
                                  dtype=dtype)
        tokens = (image_size // patch) ** 2 + (0 if no_embed_class else 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, layer_scale=layer_scale, dtype=dtype)
            for _ in range(depth))
        self.norm = LayerNorm(dim, dtype)
        self.head = Dense((dim,), (num_classes,), torch.float32)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.cls_token.copy_(torch.randn(self.cls_token.shape,
                                             generator=gen) * 0.02)
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape,
                                             generator=gen) * 0.02)

    def forward(self, x, generator=None):
        b = x.shape[0]
        # flax adds the f32 position embedding to the patches: the
        # residual stream takes the wider of the two types
        x = self.patch_embed(x).flatten(2).transpose(1, 2)
        x = x.to(torch.promote_types(x.dtype, self.pos_embed.dtype))
        if x.shape[1] + (0 if self.no_embed_class else 1) \
                != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patch tokens for a position embedding of "
                f"{self.pos_embed.shape[1]} (built for another image size)")
        cls = self.cls_token.expand(b, 1, self.dim)
        if self.no_embed_class:
            x = torch.cat([cls, x + self.pos_embed], 1)
        else:
            x = torch.cat([cls, x], 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0])


VIT_SPECS = {
    "vit_small_patch16_224": dict(dim=384, depth=12, heads=6),
    "vit_base_patch16_224": dict(dim=768, depth=12, heads=12),
    "vit_large_patch16_224": dict(dim=1024, depth=24, heads=16),
    "deit3_small_patch16_224": dict(dim=384, depth=12, heads=6,
                                    layer_scale=1e-6, no_embed_class=True),
    "deit3_base_patch16_224": dict(dim=768, depth=12, heads=12,
                                   layer_scale=1e-6, no_embed_class=True),
    "deit3_large_patch16_224": dict(dim=1024, depth=24, heads=16,
                                    layer_scale=1e-6, no_embed_class=True),
}
