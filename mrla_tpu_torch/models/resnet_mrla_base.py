"""ResNet with MRLA-base (paper eq. 6), eval forward: every block attends
over its stage's growing K/V cache with a softmax over the layer axis.

Block: bottleneck -> out = relu(z + identity) -> out + ReLU(BN(mrla(out,
cache))), with dim_perhead=16 (one channel a head with ``channel_wise``);
the cache restarts at every stage head, where H, W and C change.  The stem
is the 3-conv deep stem (stem_width 32).  The ``resnet50_mrlab22`` ablation
has the 7x7 stem and no ReLU on attn (``deep_stem=False,
relu_on_attn=False``).  ``se=True`` puts the SE gate, and ``eca`` (taps a
stage) the ECA gate, after bn3 and before the residual, as in the
baseline ResNet (``models/resnet.py``); ``groups`` and
``width_per_group`` widen the 3x3 as ResNeXt's.

Training (``model.train()``): BN on batch statistics (the JAX package's
running-variance rule, ``models/common.py``), DropPath at ``drop_path`` on
the attention branch of every block and dropout at ``drop_rate`` before
``fc``, their masks from the generator ``nn.set_generator`` hands them.

The module tree and ``state_dict`` keys follow the reference (``conv1.{0,1,
3,4,6}`` and ``bn1`` for the deep stem, ``layer{s}.{b}.conv{i}``,
``layer{s}.{b}.downsample.{0,1}``, ``layer{s}.{b}.mrla.mrla.W{q,k,v}``,
``layer{s}.{b}.bn_mrla``, ``.se.fc.{0,2}``, ``.eca.conv``, ``fc``); the JAX package's
``convert_mrla_base_state_dict`` takes them as they are.

``forward`` takes NHWC images and returns fp32 logits; with
``features_only=True`` the per-stage NHWC maps instead.  Each stage's cache
lives in buffers allocated once for the stage's depth
(``ops.mrla.cache_buffers``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.models.common import (
    batch_norm,
    classifier_fc,
    conv1x1,
    conv3x3,
    deep_stem as make_deep_stem,
    downsample,
    stem7x7,
)
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import (
    DropPath,
    Dropout,
    ECALayer,
    MRLABaseModule,
    SELayer,
)


class MRLABaseBottleneck(nn.Module):
    """Bottleneck + MRLA-base epilogue; threads the stage's cache."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dim_perhead: int = 16,
                 channel_wise: bool = False, relu_on_attn: bool = True,
                 zero_init_last_bn: bool = True, se: bool = False,
                 eca_size: Optional[int] = None, groups: int = 1,
                 base_width: int = 64, drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.relu_on_attn = relu_on_attn
        self.conv1 = conv1x1(inplanes, width, generator=generator)
        self.bn1 = batch_norm(width)
        self.conv2 = conv3x3(width, width, stride, generator, groups)
        self.bn2 = batch_norm(width)
        self.conv3 = conv1x1(width, out_ch, generator=generator)
        self.bn3 = batch_norm(out_ch, zero_init=zero_init_last_bn)
        self.se = SELayer(out_ch, generator=generator) if se else None
        self.eca = (ECALayer(out_ch, eca_size, generator)
                    if eca_size is not None else None)
        self.downsample = (
            downsample(inplanes, out_ch, stride, generator)
            if use_downsample else None
        )
        self.mrla = MRLABaseModule(out_ch, dim_perhead, channel_wise,
                                   generator=generator)
        self.bn_mrla = batch_norm(out_ch)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, cache, max_t: Optional[int] = None):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        if self.eca is not None:
            out = self.eca(out)
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(out + identity)
        attn, cache = self.mrla(out, cache, max_t)
        attn = self.bn_mrla(attn)
        if self.relu_on_attn:
            attn = F.relu(attn)
        return out + self.drop_path(attn), cache


class ResNetMRLABase(nn.Module):
    """ResNet_mrlab classifier (the cache restarts at every stage)."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 dim_perhead: int = 16, channel_wise: bool = False,
                 deep_stem: bool = True, relu_on_attn: bool = True,
                 se: bool = False, eca=None, groups: int = 1,
                 width_per_group: int = 64, drop_rate: float = 0.0,
                 drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 features_only: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.drop_rate, self.drop_path = drop_rate, drop_path
        eca = tuple(eca) if eca else (None,) * len(self.layers)
        self.features_only = features_only
        self.conv1, self.bn1 = (
            make_deep_stem(32, 64, generator) if deep_stem
            else stem7x7(64, generator))
        inplanes, planes = 64, 64
        for stage_idx, blocks in enumerate(layers):
            stage = []
            for block_idx in range(blocks):
                first = block_idx == 0
                stage.append(MRLABaseBottleneck(
                    inplanes, planes,
                    stride=2 if (first and stage_idx > 0) else 1,
                    use_downsample=first, dim_perhead=dim_perhead,
                    channel_wise=channel_wise, relu_on_attn=relu_on_attn,
                    se=se, eca_size=eca[stage_idx], groups=groups,
                    base_width=width_per_group, drop_path=drop_path,
                    generator=generator,
                ))
                inplanes = planes * MRLABaseBottleneck.expansion
            self.add_module(f"layer{stage_idx + 1}", nn.ModuleList(stage))
            planes *= 2
        if not features_only:
            self.head_drop = Dropout(drop_rate)
            self.fc = classifier_fc(inplanes, num_classes, generator)

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] -> logits [B, num_classes] fp32, or with
        ``features_only`` the tuple of per-stage NHWC maps."""
        w = self.bn1.weight
        x = x.to(w.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage_idx in range(len(self.layers)):
            stage = getattr(self, f"layer{stage_idx + 1}")
            cache = None  # init_cell: a new stage, a new cache
            for block in stage:
                x, cache = block(x, cache, max_t=len(stage))
            outs.append(x.permute(0, 2, 3, 1))
        if self.features_only:
            return tuple(outs)
        return self.fc(self.head_drop(x.mean(dim=(2, 3)))).float()


@register_model
def resnet50_mrlab(**kw):
    return ResNetMRLABase(layers=[3, 4, 6, 3], **kw)


@register_model
def resnet101_mrlab(**kw):
    return ResNetMRLABase(layers=[3, 4, 23, 3], **kw)


@register_model
def resnet152_mrlab(**kw):
    return ResNetMRLABase(layers=[3, 8, 36, 3], **kw)


@register_model
def resnet50_mrlab22(**kw):
    """The 'base22' ablation: 7x7 stem, no ReLU on attn."""
    return ResNetMRLABase(layers=[3, 4, 6, 3], deep_stem=False,
                          relu_on_attn=False, **kw)
