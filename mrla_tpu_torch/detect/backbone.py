"""MRLA backbone + FPN neck with the MMDetection contract: the backbone is
``ResNetMRLALight(features_only=True)`` (C2..C5, no DropPath, eval), the
neck :class:`FPN`; ``state_dict`` keys ``backbone.*`` and ``neck.*``.

:func:`freeze_stages` is the backbone's ``frozen_stages`` for training (the
JAX package's ``freeze_mask``); :func:`load_backbone_from_classification`
copies a classification checkpoint into a detector's backbone (mmdet's
``init_cfg=Pretrained``)."""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from mrla_tpu_torch.detect.fpn import FPN
from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight


class MRLABackboneFPN(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 start_level: int = 0,
                 add_extra_convs: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNetMRLALight(list(layers), features_only=True,
                                        generator=generator)
        self.neck = FPN(start_level=start_level,
                        add_extra_convs=add_extra_convs, generator=generator)

    def forward(self, x: torch.Tensor) -> tuple:
        """[B, H, W, 3] NHWC images -> the pyramid, NHWC: (P2, .., P6) by
        default, (P3, .., P7) with RetinaNet's ``start_level=1``."""
        return self.neck(self.backbone(x))


def load_backbone_from_classification(
        detector: nn.Module, cls_state_dict: Mapping[str, torch.Tensor],
        scope: str = "backbone") -> nn.Module:
    """Copy every ``<scope>.*`` entry of ``detector``'s state_dict from the
    classification state_dict (the same keys without the scope: the
    backbone is the classification trunk; its ``fc`` is ignored), in place;
    the neck and the heads keep their init.  Raises if an entry is missing
    from the checkpoint or has another shape."""
    own = detector.state_dict()
    loaded = {}
    for key, val in own.items():
        if not key.startswith(scope + "."):
            continue
        src = cls_state_dict.get(key[len(scope) + 1:])
        if src is None:
            raise KeyError(f"classification checkpoint lacks "
                           f"{key[len(scope) + 1:]}")
        if tuple(src.shape) != tuple(val.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(src.shape)} vs {tuple(val.shape)}")
        loaded[key] = src
    detector.load_state_dict(loaded, strict=False)
    return detector


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
