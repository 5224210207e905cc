"""ResNet with the MRLA-light epilogue (the flagship family), eval forward.

Block: bottleneck -> (+identity, relu) -> out + BN(mrla(out) + λ·identity),
with dim_perhead=32 and λ ~ N(0, 1); 7x7 stem; zero-init bn3.

The module tree and ``state_dict`` keys are the reference implementation's
(``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}``, ``layer{s}.{b}.downsample.{0,1}``,
``layer{s}.{b}.mrla.mrla.W{q,k,v}``, ``layer{s}.{b}.mrla.lambda_t``,
``layer{s}.{b}.bn_mrla``, ``fc``), so published checkpoints load as they are.

``forward`` takes NHWC images and returns fp32 logits; inside, the network
runs on NCHW views of NHWC memory (channels_last strides).  With
``features_only=True`` the model has no ``fc`` and returns the per-stage
maps (C2, C3, C4, C5) as NHWC views instead: the MMDetection backbone
contract (eval only; the port has no DropPath, which that variant omits).
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
    downsample,
    stem7x7,
)
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import MRLALightModule


class MRLABottleneck(nn.Module):
    """Bottleneck + MRLA-light epilogue."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dim_perhead: int = 32,
                 zero_init_last_bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv1x1(inplanes, planes, generator=generator)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv3x3(planes, planes, stride, generator=generator)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv1x1(planes, out_ch, generator=generator)
        self.bn3 = batch_norm(out_ch, zero_init=zero_init_last_bn)
        self.downsample = (
            downsample(inplanes, out_ch, stride, generator)
            if use_downsample else None
        )
        self.mrla = MRLALightModule(out_ch, dim_perhead, generator=generator)
        self.bn_mrla = batch_norm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(out + identity)
        # the recurrence input o_{t-1} is this block's (downsampled) identity
        return out + self.bn_mrla(self.mrla(out, identity))


class ResNetMRLALight(nn.Module):
    """ResNet_mrlal classifier."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 dim_perhead: int = 32,
                 generator: Optional[torch.Generator] = None,
                 features_only: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.features_only = features_only
        self.conv1, self.bn1 = stem7x7(64, generator)
        inplanes, planes = 64, 64
        for stage_idx, blocks in enumerate(layers):
            stage = []
            for block_idx in range(blocks):
                first = block_idx == 0
                stage.append(MRLABottleneck(
                    inplanes, planes,
                    stride=2 if (first and stage_idx > 0) else 1,
                    use_downsample=first, dim_perhead=dim_perhead,
                    generator=generator,
                ))
                inplanes = planes * MRLABottleneck.expansion
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*stage))
            planes *= 2
        if not features_only:
            self.fc = classifier_fc(inplanes, num_classes, generator)

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] -> logits [B, num_classes] fp32, or with
        ``features_only`` the tuple of per-stage NHWC maps."""
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage_idx in range(len(self.layers)):
            x = getattr(self, f"layer{stage_idx + 1}")(x)
            outs.append(x.permute(0, 2, 3, 1))
        if self.features_only:
            return tuple(outs)
        return self.fc(x.mean(dim=(2, 3))).float()


@register_model
def resnet50_mrlal(**kw):
    return ResNetMRLALight(layers=[3, 4, 6, 3], **kw)


@register_model
def resnet101_mrlal(**kw):
    return ResNetMRLALight(layers=[3, 4, 23, 3], **kw)


@register_model
def resnet152_mrlal(**kw):
    return ResNetMRLALight(layers=[3, 8, 36, 3], **kw)
