"""Detection presets: the backbone, neck and schedule settings of each
reference MMDetection config (the port's own copy of the JAX package's
``detect/configs.py``; nothing is imported from there).

  * faster_rcnn_r50/r101mrlal_fpn_1x_coco
    (configs/_base_/models/faster_rcnn_r50mrlal_fpn.py:15-19: FPN
    in [256, 512, 1024, 2048] -> 256 x 5 levels, max-pool extra level)
  * mask_rcnn_r50mrlal_fpn_1x_coco (the same neck, plus the mask head)
  * retinanet_r50mrlal_fpn_1x_coco (start_level=1,
    add_extra_convs='on_input'; its detector is not ported yet)

Schedules: '1x' = 12 epochs, lr steps at 8 and 11, batch 16.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class DetectionPreset:
    name: str
    backbone_layers: Sequence[int]
    pretrained_arch: str  # classification checkpoint providing the weights
    frozen_stages: int
    norm_eval: bool
    fpn_out_channels: int
    num_outs: int
    start_level: int
    add_extra_convs: Optional[str]
    # 1x schedule
    epochs: int = 12
    lr_step_epochs: Sequence[int] = field(default=(8, 11))
    global_batch: int = 16
    image_scale: Sequence[int] = field(default=(1333, 800))

    @property
    def with_mask(self) -> bool:
        return self.name.startswith("mask_rcnn")


def _two_stage(name: str, layers, arch: str) -> DetectionPreset:
    return DetectionPreset(
        name=name, backbone_layers=layers, pretrained_arch=arch,
        frozen_stages=1, norm_eval=True, fpn_out_channels=256, num_outs=5,
        start_level=0, add_extra_convs=None,
    )


PRESETS = {
    "faster_rcnn_r50mrlal_fpn_1x_coco": _two_stage(
        "faster_rcnn_r50mrlal_fpn_1x_coco", (3, 4, 6, 3), "resnet50_mrlal"),
    "faster_rcnn_r101mrlal_fpn_1x_coco": _two_stage(
        "faster_rcnn_r101mrlal_fpn_1x_coco", (3, 4, 23, 3),
        "resnet101_mrlal"),
    "mask_rcnn_r50mrlal_fpn_1x_coco": _two_stage(
        "mask_rcnn_r50mrlal_fpn_1x_coco", (3, 4, 6, 3), "resnet50_mrlal"),
    "retinanet_r50mrlal_fpn_1x_coco": DetectionPreset(
        name="retinanet_r50mrlal_fpn_1x_coco",
        backbone_layers=(3, 4, 6, 3),
        pretrained_arch="resnet50_mrlal",
        frozen_stages=1,
        norm_eval=True,
        fpn_out_channels=256,
        num_outs=5,
        start_level=1,
        add_extra_convs="on_input",
    ),
}
