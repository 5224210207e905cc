"""MRLA backbone + FPN neck with the MMDetection contract: the backbone is
``ResNetMRLALight(features_only=True)`` (C2..C5, no DropPath, eval), the
neck :class:`FPN`; ``state_dict`` keys ``backbone.*`` and ``neck.*``.

:func:`freeze_stages` is the backbone's ``frozen_stages`` for training (the
JAX package's ``freeze_mask``)."""

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


def freeze_stages(detector: nn.Module, frozen_stages: int) -> list:
    """mmdet ``frozen_stages`` on ``detector.backbone``: -1 freezes nothing,
    0 the stem (conv1, bn1), k >= 1 also layer1..layerk.  Frozen parameters
    get ``requires_grad=False``; returns the parameters that still train
    (BN affines of the later stages among them), in module order, for the
    optimizer.  The JAX package masks the frozen ones' updates to zero
    instead, which leaves the same parameters."""
    frozen = []
    if frozen_stages >= 0:
        frozen = ["conv1.", "bn1."] + [f"layer{s}."
                                       for s in range(1, frozen_stages + 1)]
    for name, p in detector.backbone.named_parameters():
        if any(name.startswith(f) for f in frozen):
            p.requires_grad_(False)
    return [p for p in detector.parameters() if p.requires_grad]
