"""Two-stage detection (Faster / Mask R-CNN on the MRLA backbone + FPN),
PyTorch: presets, anchors, box coding and NMS, RoIAlign, the FPN neck, the
backbone export and the detectors.

The detectors (``FasterRCNN``, ``MaskRCNN``, ``two_stage_predict``, ...)
are imported from ``detect.two_stage``: it needs the kernels package, which
imports ``detect.roi_align``, so this package does not import it."""

from mrla_tpu_torch.detect.anchors import (
    base_anchors,
    grid_anchors,
    pyramid_anchors,
)
from mrla_tpu_torch.detect.backbone import MRLABackboneFPN
from mrla_tpu_torch.detect.bbox import (
    bbox2delta,
    bbox_overlaps,
    delta2bbox,
    multiclass_nms_fixed,
    nms_fixed,
)
from mrla_tpu_torch.detect.configs import PRESETS, DetectionPreset
from mrla_tpu_torch.detect.fpn import FPN, fpn_forward
from mrla_tpu_torch.detect.roi_align import (
    batched_roi_align,
    default_max_grid,
    map_roi_levels,
    roi_align_reference,
    roi_geometry,
)

__all__ = [
    "FPN", "DetectionPreset", "MRLABackboneFPN", "PRESETS", "base_anchors",
    "batched_roi_align", "bbox2delta", "bbox_overlaps", "default_max_grid",
    "delta2bbox", "fpn_forward", "grid_anchors", "map_roi_levels",
    "multiclass_nms_fixed", "nms_fixed", "pyramid_anchors",
    "roi_align_reference", "roi_geometry",
]
