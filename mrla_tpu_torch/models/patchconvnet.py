"""PatchConvNet baselines (the DeiT repository's, no MRLA): a ConvStem of
four 3x3 stride-2 convs (exact GELU between them), ``depth`` layer-scaled
SE-conv blocks on the token grid, one learned-aggregation class-attention
block, a linear head.  Sizes S60 / S120 / B60 / B120 / L60 / L120 and
S60_multi.

Block: x + DropPath(γ ⊙ convblock(LN(x))), convblock = 1x1 -> GELU ->
depthwise 3x3 -> GELU -> SE -> 1x1 (every conv biased); the SE has biased
fp32 projections, ``rd_ratio`` 0.25 and a ReLU.  Class attention: the cls
token attends over [cls; tokens] (one head); the multi-class model has a
cls token per class, whose queries attend over the patch tokens only, and
a 1-logit head per class.  LayerNorm eps 1e-6.

The ``state_dict`` keys are the reference's: ``patch_embed.proj.{0,2,4,6}.0``
(the stem convs), ``blocks.{i}.norm1``, ``blocks.{i}.gamma_1``,
``blocks.{i}.attn.qkv_pos.{0,2,5}`` (1x1, depthwise, 1x1),
``blocks.{i}.attn.qkv_pos.4.conv_{reduce,expand}`` (the SE),
``cls_token``, ``blocks_token_only.0.{norm1,norm2,gamma_1,gamma_2}``,
``blocks_token_only.0.attn.{q,k,v,proj}``,
``blocks_token_only.0.mlp.{fc1,fc2}``, ``norm``, ``head`` (multi-class:
``head.{i}``, a Linear(C, 1) a class).

``forward`` takes NHWC images and returns fp32 logits;
``forward_features`` gives the tokens after the conv blocks and
``forward_head`` the class attention, the norm and the head.  In training
DropPath at ``drop_path_rate`` on every conv block (a flat rate).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.models.deit import (
    Mlp,
    layer_norm,
    linear,
    trunc_normal_,
)
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import DropPath
from mrla_tpu_torch.ops.channel_gates import dense_fp32
from mrla_tpu_torch.ops.common import rowwise


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1,
          groups: int = 1, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, k, stride, padding=k // 2,
                     groups=groups, bias=bias)
    trunc_normal_(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class ConvStem(nn.Module):
    """[B, H, W, 3] -> [B, N, C] tokens at 1/16 the side."""

    def __init__(self, embed_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [3, embed_dim // 8, embed_dim // 4, embed_dim // 2, embed_dim]
        layers = []
        for i in range(4):
            if i:
                layers.append(nn.GELU())
            layers.append(nn.Sequential(_conv(dims[i], dims[i + 1], 3, 2,
                                              bias=False,
                                              generator=generator)))
        self.proj = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class SqueezeExcite(nn.Module):
    """fp32 GAP -> conv_reduce -> ReLU -> conv_expand -> sigmoid (biased
    1x1 projections in fp32)."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_reduce = _conv(channels, channels // 4, 1,
                                 generator=generator)
        self.conv_expand = _conv(channels // 4, channels, 1,
                                 generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.mean(x, dim=(2, 3), dtype=torch.float32)
        y = F.relu(dense_fp32(y, self.conv_reduce.weight,
                              self.conv_reduce.bias))
        y = dense_fp32(y, self.conv_expand.weight, self.conv_expand.bias)
        return x * rowwise(torch.sigmoid, y)[:, :, None, None].to(x.dtype)


class ConvBlockSE(nn.Module):
    """The conv block on the s x s token grid, [B, N, C] -> [B, N, C]."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.qkv_pos = nn.Sequential(
            _conv(dim, dim, 1, generator=generator), nn.GELU(),
            _conv(dim, dim, 3, groups=dim, generator=generator), nn.GELU(),
            SqueezeExcite(dim, generator), _conv(dim, dim, 1,
                                                 generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        s = math.isqrt(n)
        g = self.qkv_pos(x.reshape(b, s, s, c).permute(0, 3, 1, 2))
        return g.permute(0, 2, 3, 1).reshape(b, n, c)


class ConvBlock(nn.Module):
    def __init__(self, dim: int, init_values: float, drop_path: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = ConvBlockSE(dim, generator)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(self.norm1(x))
        return x + self.drop_path(self.gamma_1.to(y.dtype) * y)


class LearnedAggregation(nn.Module):
    """Class attention, one head.  ``num_cls`` 0: the cls token's query
    over [cls; tokens]; else the first ``num_cls`` (class) tokens' queries
    over the patch tokens only."""

    def __init__(self, dim: int, num_cls: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_cls = num_cls
        self.q, self.k, self.v, self.proj = (
            linear(dim, dim, generator=generator) for _ in range(4))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        m = self.num_cls
        q = self.q(u[:, :max(m, 1)])
        kv = u[:, m:] if m else u
        k, v = self.k(kv), self.v(kv)
        logits = (q @ k.transpose(1, 2)).float() / math.sqrt(u.shape[-1])
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        return self.proj(attn @ v)


class ClassBlock(nn.Module):
    def __init__(self, dim: int, init_values: float, mlp_ratio: float,
                 num_cls: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = LearnedAggregation(dim, num_cls, generator)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), 0.0, generator)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, cls: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        y = self.attn(self.norm1(torch.cat([cls, tokens], dim=1)))
        cls = cls + self.gamma_1.to(y.dtype) * y
        y = self.mlp(self.norm2(cls))
        return cls + self.gamma_2.to(y.dtype) * y


class PatchConvNet(nn.Module):
    def __init__(self, num_classes: int = 1000, embed_dim: int = 384,
                 depth: int = 60, init_scale: float = 1e-6,
                 mlp_ratio_clstk: float = 3.0, drop_path_rate: float = 0.0,
                 multiclass: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = embed_dim
        self.multiclass = multiclass
        n_cls = num_classes if multiclass else 1
        self.patch_embed = ConvStem(c, generator)
        self.blocks = nn.ModuleList(
            ConvBlock(c, init_scale, drop_path_rate, generator)
            for _ in range(depth))
        self.cls_token = nn.Parameter(torch.empty(1, n_cls, c))
        trunc_normal_(self.cls_token, generator)
        self.blocks_token_only = nn.ModuleList([ClassBlock(
            c, init_scale, mlp_ratio_clstk, n_cls if multiclass else 0,
            generator)])
        self.norm = layer_norm(c)
        if multiclass:
            self.head = nn.ModuleList(linear(c, 1, generator=generator)
                                      for _ in range(num_classes))
        else:
            self.head = linear(c, num_classes, generator=generator)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.cls_token.dtype))
        for blk in self.blocks:
            x = blk(x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        cls = self.norm(self.blocks_token_only[0](cls, x))
        if not self.multiclass:
            return self.head(cls[:, 0]).float()
        # one Linear(C, 1) a class on its own token, in fp32
        w = torch.cat([h.weight for h in self.head]).float()  # [K, C]
        b = torch.cat([h.bias for h in self.head]).float()
        with torch.autocast(x.device.type, enabled=False):
            return (cls.float() * w).sum(-1) + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> logits [B, num_classes] fp32."""
        return self.forward_head(self.forward_features(x))


@register_model
def patchconvnet_s60(**kw):
    return PatchConvNet(embed_dim=384, depth=60, init_scale=1e-6, **kw)


@register_model
def patchconvnet_s120(**kw):
    return PatchConvNet(embed_dim=384, depth=120, init_scale=1e-6, **kw)


@register_model
def patchconvnet_b60(**kw):
    return PatchConvNet(embed_dim=768, depth=60, init_scale=1e-6, **kw)


@register_model
def patchconvnet_b120(**kw):
    return PatchConvNet(embed_dim=768, depth=120, init_scale=1e-6, **kw)


@register_model
def patchconvnet_l60(**kw):
    return PatchConvNet(embed_dim=1024, depth=60, init_scale=1e-6, **kw)


@register_model
def patchconvnet_l120(**kw):
    return PatchConvNet(embed_dim=1024, depth=120, init_scale=1e-6, **kw)


@register_model
def patchconvnet_s60_multi(**kw):
    """One cls token a class, multi-query class attention, a 1-logit head
    a class; the reference's factory leaves init_scale at its 1e-4."""
    return PatchConvNet(embed_dim=384, depth=60, init_scale=1e-4,
                        multiclass=True, **kw)
