"""ResMLP baselines (the DeiT repository's, no MRLA): Affine pre-norms,
token mixing by a Linear across the patch axis (on the transposed
[B, C, N] tokens), a per-channel layer scale on both residual branches,
mean-pooled head.  Sizes resmlp_12 / 24 / 36 and resmlpB_24 (patch 8),
each with its own layer-scale init.

The ``state_dict`` keys are the reference's (``patch_embed.proj``,
``blocks.{i}.norm{1,2}.{alpha,beta}``, ``blocks.{i}.attn`` (the token
mixer), ``blocks.{i}.mlp.{fc1,fc2}``, ``blocks.{i}.gamma_{1,2}``,
``norm.{alpha,beta}``, ``head``).  The token mixer is sized for
``img_size`` (its patch count).

``forward`` takes NHWC images and returns fp32 logits;
``forward_features`` gives the tokens after the last block and
``forward_head`` the norm, the pool and the head.  In training: dropout at
``drop_rate`` in every MLP and DropPath at ``drop_path_rate`` on both
branches of every block (a flat rate), masks from the generator
``nn.set_generator`` hands them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mrla_tpu_torch.models.deit import Mlp, PatchEmbed, linear
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import DropPath


class Affine(nn.Module):
    """alpha ⊙ x + beta, the weights taken to x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha.to(x.dtype) * x + self.beta.to(x.dtype)


class ResMLPBlock(nn.Module):
    def __init__(self, dim: int, num_patches: int, init_values: float = 1e-4,
                 drop: float = 0.0, drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = Affine(dim)
        self.attn = linear(num_patches, num_patches, generator=generator)
        self.norm2 = Affine(dim)
        self.mlp = Mlp(dim, 4 * dim, drop, generator)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        self.drop_path1, self.drop_path2 = DropPath(drop_path), DropPath(
            drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(self.norm1(x).transpose(1, 2)).transpose(1, 2)
        x = x + self.drop_path1(self.gamma_1.to(y.dtype) * y)
        y = self.mlp(self.norm2(x))
        return x + self.drop_path2(self.gamma_2.to(y.dtype) * y)


class ResMLP(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 384,
                 depth: int = 12, init_scale: float = 1e-4,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, generator)
        self.blocks = nn.ModuleList(
            ResMLPBlock(embed_dim, n, init_scale, drop_rate, drop_path_rate,
                        generator) for _ in range(depth))
        self.norm = Affine(embed_dim)
        self.head = linear(embed_dim, num_classes, generator=generator)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.patch_embed.proj.weight.dtype))
        for blk in self.blocks:
            x = blk(x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.norm(x).mean(dim=1)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> logits [B, num_classes] fp32."""
        return self.forward_head(self.forward_features(x))


@register_model
def resmlp_12(**kw):
    return ResMLP(embed_dim=384, depth=12, init_scale=0.1, **kw)


@register_model
def resmlp_24(**kw):
    return ResMLP(embed_dim=384, depth=24, init_scale=1e-5, **kw)


@register_model
def resmlp_36(**kw):
    return ResMLP(embed_dim=384, depth=36, init_scale=1e-6, **kw)


@register_model
def resmlpB_24(**kw):
    return ResMLP(patch_size=8, embed_dim=768, depth=24, init_scale=1e-6,
                  **kw)
