"""MRLA backbone + FPN neck with the MMDetection contract: the backbone is
``ResNetMRLALight(features_only=True)`` (C2..C5, no DropPath, eval), the
neck :class:`FPN`; ``state_dict`` keys ``backbone.*`` and ``neck.*``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mrla_tpu_torch.detect.fpn import FPN
from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight


class MRLABackboneFPN(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNetMRLALight(list(layers), features_only=True,
                                        generator=generator)
        self.neck = FPN(generator=generator)

    def forward(self, x: torch.Tensor) -> tuple:
        """[B, H, W, 3] NHWC images -> the pyramid (P2, .., P6), NHWC."""
        return self.neck(self.backbone(x))
