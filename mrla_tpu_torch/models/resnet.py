"""The baseline ResNet / ResNeXt family, with the optional SE or ECA gate,
and the depthwise-conv ablation ``resnet50_dw``.

Block: 1x1 -> 3x3 (stride, ``groups``) -> 1x1, each with BN (bn3
zero-initialised), then the SE or ECA gate, then relu(out + identity).
ResNeXt widens the 3x3 to ``planes · width_per_group / 64 · groups``
channels in ``groups`` groups (32x4d).  ECA takes its taps per stage,
(5, 5, 5, 7).  The ablation adds ``out + DropPath(BN(dw3x3(out)))``
*after* the ReLU: the MRLA-light epilogue's depthwise conv alone.

The module tree and ``state_dict`` keys are the reference
implementation's (``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}`` /
``bn{i}``, ``.downsample.{0,1}``, ``.se.fc.{0,2}``, ``.eca.conv``,
``.dwconv``, ``.bn_dw``, ``fc``), which the JAX package's
``convert_resnet_state_dict`` reads.

``forward`` takes NHWC images and returns fp32 logits (with
``features_only`` the per-stage NHWC maps); ``forward_features`` is the
trunk up to the last map and ``forward_head`` the pooled classifier, which
the serving engine runs once over a batch's microbatch chains.  In
training: BN on batch statistics (the JAX running-variance rule), DropPath
at ``drop_path`` on the ablation's branch and dropout at ``drop_rate``
before ``fc``, their masks from the generator ``nn.set_generator`` hands
them.  A factory given ``layers`` builds that depth instead of its own
(the trainer's ``--layers``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.models.common import (
    batch_norm,
    classifier_fc,
    conv1x1,
    conv3x3,
    downsample,
    stem7x7,
)
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import DropPath, Dropout, ECALayer, SELayer


class Bottleneck(nn.Module):
    """Bottleneck with an optional SE / ECA gate and depthwise epilogue."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, se: bool = False,
                 eca_size: Optional[int] = None, groups: int = 1,
                 base_width: int = 64, dilation: int = 1,
                 zero_init_last_bn: bool = True, dw_epilogue: bool = False,
                 drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = conv1x1(inplanes, width, generator=generator)
        self.bn1 = batch_norm(width)
        self.conv2 = conv3x3(width, width, stride, generator, groups,
                             dilation)
        self.bn2 = batch_norm(width)
        self.conv3 = conv1x1(width, out_ch, generator=generator)
        self.bn3 = batch_norm(out_ch, zero_init=zero_init_last_bn)
        self.se = SELayer(out_ch, generator=generator) if se else None
        self.eca = (ECALayer(out_ch, eca_size, generator)
                    if eca_size is not None else None)
        self.downsample = (downsample(inplanes, out_ch, stride, generator)
                           if use_downsample else None)
        self.dwconv = None
        if dw_epilogue:
            self.dwconv = nn.Conv2d(out_ch, out_ch, 3, padding=1,
                                    groups=out_ch, bias=False)
            with torch.no_grad():  # kaiming normal, fan_out = C·3·3
                self.dwconv.weight.normal_(
                    0.0, math.sqrt(2.0 / (out_ch * 9)), generator=generator)
            self.bn_dw = batch_norm(out_ch)
            self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        if self.eca is not None:
            out = self.eca(out)
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(out + identity)
        if self.dwconv is not None:
            out = out + self.drop_path(self.bn_dw(self.dwconv(out)))
        return out


class ResNet(nn.Module):
    """The baseline ResNet / ResNeXt classifier."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 se: bool = False, eca: Optional[Sequence] = None,
                 groups: int = 1, width_per_group: int = 64,
                 drop_rate: float = 0.0, drop_path: float = 0.0,
                 dw_epilogue: bool = False,
                 generator: Optional[torch.Generator] = None,
                 features_only: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.features_only = features_only
        eca = tuple(eca) if eca else (None,) * len(self.layers)
        self.conv1, self.bn1 = stem7x7(64, generator)
        inplanes, planes = 64, 64
        for stage_idx, blocks in enumerate(self.layers):
            stage = []
            for block_idx in range(blocks):
                first = block_idx == 0
                stage.append(Bottleneck(
                    inplanes, planes,
                    stride=2 if (first and stage_idx > 0) else 1,
                    use_downsample=first, se=se, eca_size=eca[stage_idx],
                    groups=groups, base_width=width_per_group,
                    dw_epilogue=dw_epilogue, drop_path=drop_path,
                    generator=generator))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*stage))
            planes *= 2
        if not features_only:
            self.head_drop = Dropout(drop_rate)
            self.fc = classifier_fc(inplanes, num_classes, generator)

    def stages(self, x: torch.Tensor) -> list:
        """[B, H, W, 3] -> every stage's map (NCHW views of NHWC memory)."""
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        outs = []
        for stage_idx in range(len(self.layers)):
            x = getattr(self, f"layer{stage_idx + 1}")(x)
            outs.append(x)
        return outs

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.stages(x)[-1]

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.head_drop(x.mean(dim=(2, 3)))).float()

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] -> logits [B, num_classes] fp32, or with
        ``features_only`` the tuple of per-stage NHWC maps."""
        if self.features_only:
            return tuple(o.permute(0, 2, 3, 1) for o in self.stages(x))
        return self.forward_head(self.forward_features(x))


def _resnet(depth, **kw):
    return ResNet(layers=kw.pop("layers", None) or depth, **kw)


_R50, _R101, _R152 = (3, 4, 6, 3), (3, 4, 23, 3), (3, 8, 36, 3)
_ECA_DEFAULT = (5, 5, 5, 7)  # the reference's per-stage ECA taps
_X32x4D = dict(groups=32, width_per_group=4)


@register_model
def resnet50(**kw):
    return _resnet(_R50, **kw)


@register_model
def resnet101(**kw):
    return _resnet(_R101, **kw)


@register_model
def resnet152(**kw):
    return _resnet(_R152, **kw)


@register_model
def resnet50_se(**kw):
    return _resnet(_R50, se=True, **kw)


@register_model
def resnet101_se(**kw):
    return _resnet(_R101, se=True, **kw)


@register_model
def resnet152_se(**kw):
    return _resnet(_R152, se=True, **kw)


@register_model
def resnet50_eca(**kw):
    return _resnet(_R50, eca=_ECA_DEFAULT, **kw)


@register_model
def resnet101_eca(**kw):
    return _resnet(_R101, eca=_ECA_DEFAULT, **kw)


@register_model
def resnet152_eca(**kw):
    return _resnet(_R152, eca=_ECA_DEFAULT, **kw)


@register_model
def resnext50_32x4d(**kw):
    return _resnet(_R50, **_X32x4D, **kw)


@register_model
def resnext50_32x4d_se(**kw):
    return _resnet(_R50, se=True, **_X32x4D, **kw)


@register_model
def resnext50_32x4d_eca(**kw):
    return _resnet(_R50, eca=_ECA_DEFAULT, **_X32x4D, **kw)


@register_model
def resnext101_32x4d(**kw):
    return _resnet(_R101, **_X32x4D, **kw)


@register_model
def resnext101_32x4d_se(**kw):
    return _resnet(_R101, se=True, **_X32x4D, **kw)


@register_model
def resnext101_32x4d_eca(**kw):
    return _resnet(_R101, eca=_ECA_DEFAULT, **_X32x4D, **kw)


@register_model
def resnet50_dw(**kw):
    """The depthwise-epilogue ablation."""
    return _resnet(_R50, dw_epilogue=True, **kw)
