"""DeiT / ViT baselines (token-major [B, N, C]).

Plain and distilled DeiT tiny / small / base at patch 16 and 224 px, the
tiny patch-8 variant and the two 384 px base variants.  LayerNorm eps is
1e-6, the MLP's GELU is the exact erf form, the distilled model's eval
output is the mean of its two heads.

The module tree and ``state_dict`` keys are the reference implementation's
(``cls_token``, ``dist_token``, ``pos_embed``, ``patch_embed.proj``,
``blocks.{i}.norm1|norm2``, ``blocks.{i}.attn.{qkv,proj}``,
``blocks.{i}.mlp.{fc1,fc2}``, ``norm``, ``head``, ``head_dist``), so
published checkpoints load as they are.  Weights and tokens are drawn from a
truncated normal (std 0.02, cut at two std); biases are zero and LayerNorms
the identity.

``forward`` takes NHWC images, as the JAX package's model does, and returns
fp32 logits; inside, tokens are [B, N, C] (``forward_features``, the
tokens after the last block; ``forward_head``, the final norm of the cls
and dist rows and the heads).  A model whose weights are bf16 and whose
LayerNorms are fp32 (the precast serving engine's) normalises in fp32.  The attention product is left to
PyTorch's fused attention (scale 1/sqrt(d), logits and softmax in fp32
inside).

Training (``model.train()``), as the JAX package's models: dropout at
``drop_rate`` after the position embedding, on the attention projection's
output and twice in the MLP, at ``attn_drop_rate`` on the attention
weights (then computed as fp32 logits and softmax, dropped, times V), and
DropPath on both residual branches at ``drop_path_rate · i / (depth - 1)``
in block i; every mask from the generator ``nn.set_generator`` hands the
model.  A distilled model returns ``(cls_logits, dist_logits)`` in
training and their mean in eval.  Eval mode ignores every rate.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import DropPath, Dropout

LN_EPS = 1e-6


def trunc_normal_(t: torch.Tensor, generator: Optional[torch.Generator],
                  std: float = 0.02) -> torch.Tensor:
    """N(0, std) cut at two std, drawn from ``generator``."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def linear(in_features: int, out_features: int, bias: bool = True,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    fc = nn.Linear(in_features, out_features, bias=bias)
    trunc_normal_(fc.weight, generator)
    if bias:
        nn.init.zeros_(fc.bias)
    return fc


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that also takes input of a narrower dtype than its
    weights (a bf16 serving model keeps its norms fp32): then the
    statistics and the affine are fp32 and the result is rounded to the
    input's dtype once, as the JAX package's LayerNorm computes with a
    ``dtype``.  Under ``torch.autocast`` it is ``nn.LayerNorm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (x.dtype == self.weight.dtype
                or torch.is_autocast_enabled(x.device.type)):
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def layer_norm(channels: int) -> LayerNorm:
    return LayerNorm(channels, eps=LN_EPS)


def attention(qkv: torch.Tensor, num_heads: int,
              attn_drop: Optional[nn.Module] = None) -> torch.Tensor:
    """Multi-head self-attention from the fused projection [B, N, 3C]
    (q, k, v one after the other, each split into heads of d = C / heads
    channels) -> [B, N, C].  With ``attn_drop`` (a ``Dropout``) the weights
    go through it: fp32 logits and softmax, cast to q's dtype, dropped."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, n, 3, num_heads, c // num_heads).permute(
        2, 0, 3, 1, 4)  # each [B, h, N, d]
    if attn_drop is None:
        out = F.scaled_dot_product_attention(q, k, v)
    else:
        logits = (q @ k.transpose(-2, -1)).float() * (1.0 / math.sqrt(
            c // num_heads))
        out = attn_drop(torch.softmax(logits, dim=-1).to(q.dtype)) @ v
    return out.transpose(1, 2).reshape(b, n, c)


class PatchEmbed(nn.Module):
    """Conv patchifier: [B, H, W, 3] -> [B, N, C]."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        trunc_normal_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Standard multi-head self-attention (fused qkv projection)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)
        self.qkv = linear(dim, 3 * dim, qkv_bias, generator)
        self.proj = linear(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = self.attn_drop if (self.training
                                  and self.attn_drop.p > 0.0) else None
        return self.proj_drop(self.proj(
            attention(self.qkv(x), self.num_heads, drop)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop = Dropout(drop)
        self.fc1 = linear(dim, hidden, generator=generator)
        self.fc2 = linear(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(self.fc1(x)))  # exact erf GELU
        return self.drop(self.fc2(x))


class ViTBlock(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_path1, self.drop_path2 = DropPath(drop_path), DropPath(
            drop_path)
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              generator)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, generator)

    @property
    def drop_path(self) -> float:
        """The DropPath rate of both residual branches."""
        return self.drop_path1.rate

    @drop_path.setter
    def drop_path(self, rate: float) -> None:
        self.drop_path1.rate = self.drop_path2.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x)))
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class VisionTransformer(nn.Module):
    """DeiT-style ViT, optionally distilled (dist token + second head);
    ``block_cls`` builds its blocks (with ``block_kw``)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 distilled: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 block_cls: type = ViTBlock, **block_kw):
        super().__init__()
        self.patch_size, self.num_heads = patch_size, num_heads
        self.distilled = distilled
        self.drop_rate = drop_rate
        self.pos_drop = Dropout(drop_rate)
        num_tokens = 2 if distilled else 1
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        trunc_normal_(self.cls_token, generator)
        if distilled:
            self.dist_token = nn.Parameter(torch.empty(1, 1, embed_dim))
            trunc_normal_(self.dist_token, generator)
        self.pos_embed = nn.Parameter(
            torch.empty(1, n_patches + num_tokens, embed_dim))
        trunc_normal_(self.pos_embed, generator)
        self.blocks = nn.ModuleList(
            block_cls(embed_dim, num_heads, mlp_ratio=mlp_ratio,
                      qkv_bias=qkv_bias, drop=drop_rate,
                      attn_drop=attn_drop_rate, drop_path=dpr,
                      generator=generator, **block_kw)
            for dpr in (drop_path_rate * i / max(1, depth - 1)
                        for i in range(depth)))
        self.norm = layer_norm(embed_dim)
        self.head = linear(embed_dim, num_classes, generator=generator)
        if distilled:
            self.head_dist = linear(embed_dim, num_classes,
                                    generator=generator)

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] -> logits [B, num_classes] fp32 (a distilled model
        in training: the pair (cls, dist))."""
        return self.forward_head(self.forward_features(x))

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> the tokens [B, N, C] after the last block."""
        tokens = self.patch_embed(x.to(self.pos_embed.dtype))
        b = tokens.shape[0]
        parts = [self.cls_token.expand(b, -1, -1)]
        if self.distilled:
            parts.append(self.dist_token.expand(b, -1, -1))
        return self.run_blocks(self.pos_drop(
            torch.cat(parts + [tokens], dim=1) + self.pos_embed))

    def forward_head(self, x: torch.Tensor):
        """The final norm of the cls (and dist) rows and the heads."""
        x = self.norm(x[:, :2 if self.distilled else 1])
        if self.distilled:
            cls, dist = self.head(x[:, 0]), self.head_dist(x[:, 1])
            if self.training:
                return cls.float(), dist.float()
            return ((cls + dist) / 2).float()
        return self.head(x[:, 0]).float()

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The tokens [B, N, C] through every block."""
        for blk in self.blocks:
            x = blk(x)
        return x


def _vit(embed_dim, depth, num_heads, patch_size=16, **kw):
    return VisionTransformer(patch_size=patch_size, embed_dim=embed_dim,
                             depth=depth, num_heads=num_heads, **kw)


@register_model
def deit_tiny_patch16_224(**kw):
    return _vit(192, 12, 3, **kw)


@register_model
def deit_small_patch16_224(**kw):
    return _vit(384, 12, 6, **kw)


@register_model
def deit_base_patch16_224(**kw):
    return _vit(768, 12, 12, **kw)


@register_model
def deit_tiny_patch8_224(**kw):
    return _vit(192, 12, 3, patch_size=8, **kw)


@register_model
def deit_tiny_distilled_patch16_224(**kw):
    return _vit(192, 12, 3, distilled=True, **kw)


@register_model
def deit_small_distilled_patch16_224(**kw):
    return _vit(384, 12, 6, distilled=True, **kw)


@register_model
def deit_base_distilled_patch16_224(**kw):
    return _vit(768, 12, 12, distilled=True, **kw)


@register_model
def deit_base_patch16_384(**kw):
    kw.setdefault("img_size", 384)
    return _vit(768, 12, 12, **kw)


@register_model
def deit_base_distilled_patch16_384(**kw):
    kw.setdefault("img_size", 384)
    return _vit(768, 12, 12, distilled=True, **kw)
