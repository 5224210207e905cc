"""DeiT with MRLA on the token grid: the light variant (recurrent λ) and
the base variant (a K/V cache over the blocks).  Training is the plain
DeiT's (``models/deit.py``); the MRLA tail itself has no dropout.

Light: every block ends in ``x + mrla(x, block_input)``, where the token
module

  * normalises both inputs (LayerNorms ``normx`` and ``normo``, eps 1e-6);
  * splits the cls token off and runs MRLA-light on the s x s token grid,
    with the exact GELU applied to V before the gate;
  * adds λ ⊙ normo to the grid tokens, λ a per-channel vector;
  * passes the *normalised* cls token through unchanged, which is the
    reference implementation's behaviour and is kept exactly.

Base (``variant="base"``): every block ends in ``x + mrla(x, cache)``,
where the token module normalises x with ``normx`` only, runs MRLA-base on
the grid against the cache of the blocks before it (softmax over them) and
passes the normalised cls token through; there is no λ and no ``normo``.
The cache restarts every ``mrlab_size`` = 4 blocks.  The reference fixes
the base variant's drop-path rates at 0.1 in every block, which the
factories keep (``drop_path_uniform``); they act in training only.

``dim_mrla`` (channels per MRLA head) is 16 at every registered size.

``state_dict`` keys are the reference's: those of ``models/deit.py`` plus
``blocks.{i}.mrla.normx`` (and ``normo``, ``lambda_t`` for light) and
``blocks.{i}.mrla.mrla.W{q,k,v}.weight``.  ``lambda_t`` is a flat [C]
vector here (the JAX package's converter flattens whatever shape a
checkpoint gives it; reshape such a checkpoint's entry to [C] before
``load_state_dict``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.models.deit import ViTBlock, VisionTransformer, layer_norm
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import MRLABaseLayer, MRLALightLayer


def _split_cls(x: torch.Tensor):
    """[B, N, C] -> cls [B, 1, C], grid [B, s, s, C] (N - 1 a square)."""
    b, n, c = x.shape
    s = math.isqrt(n - 1)
    if s * s != n - 1:
        raise ValueError(f"token count {n - 1} is not square")
    return x[:, :1], x[:, 1:].reshape(b, s, s, c)


class MRLALightTokenModule(nn.Module):
    """mrlal_module: token-space MRLA-light with λ recurrence and cls
    bypass."""

    def __init__(self, channels: int, dim_perhead: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normx = layer_norm(channels)
        self.normo = layer_norm(channels)
        self.mrla = MRLALightLayer(channels, dim_perhead=dim_perhead,
                                   act_v=F.gelu, generator=generator)
        self.lambda_t = nn.Parameter(torch.empty(channels))
        with torch.no_grad():
            self.lambda_t.normal_(0.0, 1.0, generator=generator)

    def forward(self, xt: torch.Tensor, ot_1: torch.Tensor) -> torch.Tensor:
        b, n, c = xt.shape
        cls, grid = _split_cls(self.normx(xt))
        attn = self.mrla(grid.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        tokens = attn.reshape(b, n - 1, c) \
            + self.lambda_t.to(xt.dtype) * self.normo(ot_1)[:, 1:]
        return torch.cat([cls, tokens], dim=1)


class MRLAViTBlock(ViTBlock):
    """ViT block + MRLA-light tail; the block's input feeds the recurrence."""

    def __init__(self, dim: int, num_heads: int, dim_mrla: int = 16,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(dim, num_heads, generator=generator, **kw)
        self.mrla = MRLALightTokenModule(dim, dim_mrla, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ot = x
        x = super().forward(x)
        return x + self.mrla(x, ot)


class MRLABaseTokenModule(nn.Module):
    """mrlab_module: token-space MRLA-base with the cls bypass; threads the
    cache."""

    def __init__(self, channels: int, dim_perhead: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normx = layer_norm(channels)
        self.mrla = MRLABaseLayer(channels, dim_perhead=dim_perhead,
                                  generator=generator)

    def forward(self, xt: torch.Tensor, cache, max_t: Optional[int] = None):
        b, n, c = xt.shape
        cls, grid = _split_cls(self.normx(xt))
        attn, cache = self.mrla(grid.permute(0, 3, 1, 2), cache, max_t)
        tokens = attn.permute(0, 2, 3, 1).reshape(b, n - 1, c)
        return torch.cat([cls, tokens], dim=1), cache


class MRLABaseViTBlock(ViTBlock):
    """ViT block + MRLA-base tail over the cache of the blocks before it."""

    def __init__(self, dim: int, num_heads: int, dim_mrla: int = 16,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(dim, num_heads, generator=generator, **kw)
        self.mrla = MRLABaseTokenModule(dim, dim_mrla, generator)

    def forward(self, x: torch.Tensor, cache, max_t: Optional[int] = None):
        x = super().forward(x)
        attn, cache = self.mrla(x, cache, max_t)
        return x + attn, cache


class ViTMRLA(VisionTransformer):
    """ViT_mrlal / ViT_mrlab container (``variant`` "light" or "base")."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, dim_mrla: int = 16,
                 variant: str = "light", mrlab_size: int = 4,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, drop_path_uniform: bool = False,
                 generator: Optional[torch.Generator] = None):
        blocks = {"light": MRLAViTBlock, "base": MRLABaseViTBlock}
        if variant not in blocks:
            raise ValueError(f"variant must be 'light' or 'base', got "
                             f"{variant!r}")
        super().__init__(img_size, patch_size, num_classes, embed_dim, depth,
                         num_heads, mlp_ratio, qkv_bias, False, drop_rate,
                         attn_drop_rate, drop_path_rate, generator,
                         block_cls=blocks[variant], dim_mrla=dim_mrla)
        self.dim_mrla, self.variant = dim_mrla, variant
        self.mrlab_size = mrlab_size
        if drop_path_uniform:
            for blk in self.blocks:
                blk.drop_path = drop_path_rate

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        if self.variant == "light":
            return super().run_blocks(x)
        depth = len(self.blocks)
        for i, blk in enumerate(self.blocks):
            if i % self.mrlab_size == 0:  # init_cell
                cache = None
            x, cache = blk(x, cache, min(self.mrlab_size, depth - i))
        return x


def _vit_mrla(embed_dim, depth, num_heads, variant, **kw):
    if variant == "base":  # the reference's dpr = [0.1] * 12
        kw.setdefault("drop_path_rate", 0.1)
        kw.setdefault("drop_path_uniform", True)
    return ViTMRLA(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                   variant=variant, **kw)


@register_model
def deit_mrlal_tiny_patch16_224(**kw):
    return _vit_mrla(192, 12, 3, "light", **kw)


@register_model
def deit_mrlal_small_patch16_224(**kw):
    return _vit_mrla(384, 12, 6, "light", **kw)


@register_model
def deit_mrlal_base_patch16_224(**kw):
    return _vit_mrla(768, 12, 12, "light", **kw)


@register_model
def deit_mrlab_tiny_patch16_224(**kw):
    return _vit_mrla(192, 12, 3, "base", **kw)


@register_model
def deit_mrlab_small_patch16_224(**kw):
    return _vit_mrla(384, 12, 6, "base", **kw)


@register_model
def deit_mrlab_base_patch16_224(**kw):
    return _vit_mrla(768, 12, 12, "base", **kw)
