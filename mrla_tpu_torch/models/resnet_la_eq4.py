"""ResNet with LA (paper eq. 4), eval forward: the non-recurrent ablation,
whose blocks recompute every key and value from the stacked context of
their stage's outputs.

Block: bottleneck -> out = relu(z + identity); the stage's context grows by
``out``, and the block returns BN(la(out, context)): the layer attention
replaces the activation, with no residual around it.  The context restarts
at every stage head; dim_perhead=32; 7x7 stem.  ``se=True`` puts the SE
gate, and ``eca`` (taps a stage) the ECA gate, after bn3 and before the
residual; ``groups`` and ``width_per_group`` widen the 3x3 as ResNeXt's;
in training ``drop_rate`` is the dropout before ``fc`` (its masks from the
generator ``nn.set_generator`` hands it).  The reference's block declares
a drop_path it never applies, so the model takes none.

``state_dict`` keys follow the reference (``conv1``, ``bn1``,
``layer{s}.{b}.conv{i}``, ``layer{s}.{b}.downsample.{0,1}``,
``layer{s}.{b}.la.W{q,k,v}``, ``layer{s}.{b}.bn_la``, ``.se.fc.{0,2}``,
``.eca.conv``, ``fc``).  ``forward``
takes NHWC images and returns fp32 logits.
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
from mrla_tpu_torch.nn.layers import Dropout, ECALayer, LALayer, SELayer


class LAEq4Bottleneck(nn.Module):
    """Bottleneck whose output is replaced by layer attention over the
    stage's stacked context."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dim_perhead: int = 32,
                 zero_init_last_bn: bool = True, se: bool = False,
                 eca_size: Optional[int] = None, groups: int = 1,
                 base_width: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
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
        self.la = LALayer(out_ch, dim_perhead, generator=generator)
        self.bn_la = batch_norm(out_ch)

    def forward(self, x: torch.Tensor, mem: list):
        """x NCHW and the stage's earlier outputs (NHWC) -> (y, mem with
        this block's output appended)."""
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        if self.eca is not None:
            out = self.eca(out)
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(out + identity)
        mem = mem + [out.permute(0, 2, 3, 1)]
        return self.bn_la(self.la(out, torch.stack(mem, dim=1))), mem


class ResNetLAEq4(nn.Module):
    """ResNet_la_eq4 classifier (the context restarts at every stage)."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 dim_perhead: int = 32, se: bool = False, eca=None,
                 groups: int = 1, width_per_group: int = 64,
                 drop_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = tuple(layers)
        self.drop_rate = drop_rate
        eca = tuple(eca) if eca else (None,) * len(self.layers)
        self.conv1, self.bn1 = stem7x7(64, generator)
        inplanes, planes = 64, 64
        for stage_idx, blocks in enumerate(layers):
            stage = []
            for block_idx in range(blocks):
                first = block_idx == 0
                stage.append(LAEq4Bottleneck(
                    inplanes, planes,
                    stride=2 if (first and stage_idx > 0) else 1,
                    use_downsample=first, dim_perhead=dim_perhead, se=se,
                    eca_size=eca[stage_idx], groups=groups,
                    base_width=width_per_group, generator=generator,
                ))
                inplanes = planes * LAEq4Bottleneck.expansion
            self.add_module(f"layer{stage_idx + 1}", nn.ModuleList(stage))
            planes *= 2
        self.head_drop = Dropout(drop_rate)
        self.fc = classifier_fc(inplanes, num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> logits [B, num_classes] fp32."""
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage_idx in range(len(self.layers)):
            mem = []  # a new stage, a new context
            for block in getattr(self, f"layer{stage_idx + 1}"):
                x, mem = block(x, mem)
        return self.fc(self.head_drop(x.mean(dim=(2, 3)))).float()


@register_model
def resnet50_la_eq4(**kw):
    return ResNetLAEq4(layers=[3, 4, 6, 3], **kw)


@register_model
def resnet101_la_eq4(**kw):
    return ResNetLAEq4(layers=[3, 4, 23, 3], **kw)
