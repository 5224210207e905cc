"""Detection (Faster / Mask R-CNN and RetinaNet on the MRLA backbone +
FPN), PyTorch: presets, anchors, box coding and NMS, RoIAlign, the FPN
neck, the backbone export and the detectors.

The detectors (``FasterRCNN``, ``MaskRCNN``, ``two_stage_predict``, ...;
``RetinaNet``, ``get_bboxes``) are imported from ``detect.two_stage`` and
``detect.retinanet``, their training from ``detect.two_stage_train``,
``detect.losses`` and ``detect.train_cli``: they need the kernels package,
which imports ``detect.roi_align``, so this package does not import them."""

from mrla_tpu_torch.detect.anchors import (
    base_anchors,
    grid_anchors,
    num_base_anchors,
    pyramid_anchors,
)
from mrla_tpu_torch.detect.backbone import (
    MRLABackboneFPN,
    freeze_stages,
    load_backbone_from_classification,
)
from mrla_tpu_torch.detect.bbox import (
    bbox2delta,
    bbox_overlaps,
    delta2bbox,
    multiclass_nms_fixed,
    nms_fixed,
    soft_nms_fixed,
)
from mrla_tpu_torch.detect.configs import PRESETS, DetectionPreset
from mrla_tpu_torch.detect.fpn import FPN, fpn_forward
from mrla_tpu_torch.detect.roi_align import (
    batched_roi_align,
    default_max_grid,
    map_roi_levels,
    roi_align_backward_reference,
    roi_align_reference,
    roi_footprint,
    roi_geometry,
)
from mrla_tpu_torch.detect.targets import anchor_targets, max_iou_assign

__all__ = [
    "FPN", "DetectionPreset", "MRLABackboneFPN", "PRESETS",
    "anchor_targets", "base_anchors",
    "batched_roi_align", "bbox2delta", "bbox_overlaps", "default_max_grid",
    "delta2bbox", "fpn_forward", "freeze_stages", "grid_anchors",
    "load_backbone_from_classification", "map_roi_levels", "max_iou_assign",
    "multiclass_nms_fixed", "nms_fixed", "num_base_anchors",
    "pyramid_anchors", "soft_nms_fixed",
    "roi_align_backward_reference", "roi_align_reference", "roi_footprint",
    "roi_geometry",
]
