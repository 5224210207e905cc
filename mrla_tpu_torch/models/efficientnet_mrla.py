"""EfficientNet-B0, and EfficientNet-B0 with MRLA-light
(``efficientnet_mrlal_b0``, the README's "MBConv + SE + MRLA-light"
recipe), as the JAX package re-derives them: the reference trains the
model through timm, whose source it does not ship.

MBConv: 1x1 expand -> BN -> SiLU (unless the ratio is 1) -> k x k
depthwise (stride, symmetric k // 2 padding) -> BN -> SiLU -> SE -> 1x1
project -> BN.  BN eps is 1e-3.  The SE reduces relative to the block's
*input* channels (``max(1, in // 4)``) with biased fp32 projections and
SiLU.  A residual block (stride 1, in == out: 9 of the 16) adds
``h = x + DropPath(h)``, and with MRLA-light (``dim_perhead`` 8) then
``h + DropPath(BN(mrla(h) + λ ⊙ x))``: the recurrence input o_{t-1} is the
block input x, x_t is h after the residual add.  Block i's DropPath rate is
``drop_path_rate · i / 16``.  Head: 1x1 conv to 1280 -> BN -> SiLU ->
mean -> dropout at ``drop_rate`` -> Linear.  Both rates default to 0.2.

There is no reference ``state_dict``, so the keys are the JAX package's
Flax module paths, dotted: ``stem_conv``, ``stem_bn``,
``stage{s}_{b}.{expand_conv,bn0,dw_conv,bn1,se.fc1,se.fc2,project_conv,
bn2}``, ``stage{s}_{b}.mrla.mrla.W{q,k,v}``, ``stage{s}_{b}.mrla.lambda_t``,
``stage{s}_{b}.bn_mrla``, ``head_conv``, ``head_bn``, ``classifier``.

``forward`` takes NHWC images and returns fp32 logits; ``forward_features``
runs up to the head's SiLU and ``forward_head`` pools and classifies.
Training as the other models (``models/resnet.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.models.common import BatchNorm2d, _kaiming_fan_out
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import DropPath, Dropout, MRLALightModule
from mrla_tpu_torch.ops.channel_gates import dense_fp32
from mrla_tpu_torch.ops.common import rowwise

BN_EPS = 1e-3

# (expand_ratio, out_channels, repeats, stride, kernel)
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


def _conv(in_ch: int, out_ch: int, k: int = 1, stride: int = 1,
          groups: int = 1, generator: Optional[torch.Generator] = None
          ) -> nn.Conv2d:
    return _kaiming_fan_out(nn.Conv2d(in_ch, out_ch, k, stride,
                                      padding=k // 2, groups=groups,
                                      bias=False), generator)


def _dense(in_f: int, out_f: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """Linear with the Flax Dense init: N(0, 1 / fan_in) weight (cut at two
    std), zero bias."""
    fc = nn.Linear(in_f, out_f)
    with torch.no_grad():
        std = 1.0 / math.sqrt(in_f) / 0.87962566103423978
        nn.init.trunc_normal_(fc.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        nn.init.zeros_(fc.bias)
    return fc


class SqueezeExcite(nn.Module):
    """EfficientNet SE: fp32 GAP -> fc1 -> SiLU -> fc2 -> sigmoid, the
    projections biased and in fp32."""

    def __init__(self, channels: int, reduce_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = _dense(channels, reduce_ch, generator)
        self.fc2 = _dense(reduce_ch, channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.mean(x, dim=(2, 3), dtype=torch.float32)
        y = rowwise(F.silu, dense_fp32(y, self.fc1.weight, self.fc1.bias))
        y = rowwise(torch.sigmoid,
                    dense_fp32(y, self.fc2.weight, self.fc2.bias))
        return x * y[:, :, None, None].to(x.dtype)


class MBConv(nn.Module):
    """Mobile inverted bottleneck + SE + the optional MRLA-light epilogue."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int,
                 kernel: int, drop_path: float = 0.0, use_mrla: bool = False,
                 mrla_dim_perhead: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.expand_conv = None
        if expand != 1:
            self.expand_conv = _conv(in_ch, mid, generator=generator)
            self.bn0 = _bn(mid)
        self.dw_conv = _conv(mid, mid, kernel, stride, groups=mid,
                             generator=generator)
        self.bn1 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, in_ch // 4), generator)
        self.project_conv = _conv(mid, out_ch, generator=generator)
        self.bn2 = _bn(out_ch)
        self.mrla = None
        if self.residual:
            self.drop_path = DropPath(drop_path)
            if use_mrla:
                self.mrla = MRLALightModule(out_ch, mrla_dim_perhead,
                                            generator=generator)
                self.bn_mrla = _bn(out_ch)
                self.drop_path_mrla = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = F.silu(self.bn1(self.dw_conv(h)))
        h = self.bn2(self.project_conv(self.se(h)))
        if self.residual:
            h = x + self.drop_path(h)
            if self.mrla is not None:
                m = self.bn_mrla(self.mrla(h, x))
                h = h + self.drop_path_mrla(m)
        return h


class EfficientNet(nn.Module):
    """EfficientNet-B0 trunk (width and depth multipliers 1.0)."""

    def __init__(self, num_classes: int = 1000, use_mrla: bool = False,
                 drop_rate: float = 0.2, drop_path_rate: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stem_conv = _conv(3, 32, 3, 2, generator=generator)
        self.stem_bn = _bn(32)
        total = sum(r for (_, _, r, _, _) in B0_BLOCKS)
        self.block_names, idx, in_ch = [], 0, 32
        for si, (expand, out_ch, repeats, stride, kernel) in enumerate(
                B0_BLOCKS):
            for bi in range(repeats):
                name = f"stage{si}_{bi}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, stride if bi == 0 else 1, kernel,
                    drop_path_rate * idx / total, use_mrla,
                    generator=generator))
                self.block_names.append(name)
                in_ch, idx = out_ch, idx + 1
        self.head_conv = _conv(in_ch, 1280, generator=generator)
        self.head_bn = _bn(1280)
        self.head_drop = Dropout(drop_rate)
        self.classifier = _dense(1280, num_classes, generator)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.stem_conv.weight.dtype).permute(0, 3, 1, 2)
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return F.silu(self.head_bn(self.head_conv(x)))

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.head_drop(x.mean(dim=(2, 3)))).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> logits [B, num_classes] fp32."""
        return self.forward_head(self.forward_features(x))


@register_model
def efficientnet_b0(**kw):
    return EfficientNet(**kw)


@register_model
def efficientnet_mrlal_b0(**kw):
    """The README-recipe model (MBConv + SE + MRLA-light)."""
    return EfficientNet(use_mrla=True, **kw)
