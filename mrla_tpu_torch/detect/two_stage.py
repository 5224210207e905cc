"""Two-stage detectors (Faster / Mask R-CNN) on the MRLA backbone, eval.

The counterpart of the JAX package's ``detect/two_stage.py``, with the
mmdet module tree and ``state_dict`` keys (``backbone``, ``neck``,
``rpn_head``, ``roi_head.bbox_head``, ``roi_head.mask_head``), so an mmdet
checkpoint loads as it is:

  * ``RPNHead``: shared 3x3 conv -> ReLU -> 1x1 objectness (A, sigmoid) and
    1x1 regression (4A); anchors scale 8, ratios (0.5, 1, 2), strides
    (4, 8, 16, 32, 64);
  * ``rpn_proposals``: per level the top ``nms_pre`` (stable order, as
    ``jax.lax.top_k``), decode, clip, NMS at IoU 0.7 across levels that
    never suppress each other, the top ``max_per_img``, at fixed shapes;
  * ``Shared2FCBBoxHead``: flatten the [C, 7, 7] RoI features, two fc(1024),
    softmax over num_classes + 1 (background last) and class-specific box
    deltas (stds 0.1, 0.1, 0.2, 0.2);
  * ``FCNMaskHead``: four 3x3 convs, a 2x2 stride-2 transposed conv, 1x1
    per-class logits at 28 x 28;
  * ``FasterRCNN`` / ``MaskRCNN``: backbone (features only) + FPN + heads;
    RoIAlign on P2..P5 through ``kernels.roi_align_patch`` (the CUDA kernel
    for CUDA tensors, its plain version on the CPU).

Tensors are NHWC at every public function, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.detect.anchors import pyramid_anchors
from mrla_tpu_torch.detect.bbox import (
    delta2bbox,
    gather_rows,
    multiclass_nms_fixed,
    nms_fixed,
    sort_desc,
)
from mrla_tpu_torch.detect.fpn import FPN, ConvModule, xavier_uniform
from mrla_tpu_torch.kernels.roialign_patch import roi_align_patch
from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight
from mrla_tpu_torch.ops.common import conv2d_nhwc

RCNN_TARGET_STDS = (0.1, 0.1, 0.2, 0.2)
ROI_STRIDES = (4, 8, 16, 32)
ROI_SIZE = 7  # the box head's RoI features, 7 x 7 (the mask head's 14)
FPN_CHANNELS = 256
RPN_STRIDES = (4, 8, 16, 32, 64)


def _normal(layer: nn.Module, std: float,
            generator: Optional[torch.Generator]) -> nn.Module:
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()
    return layer


class RPNHead(nn.Module):
    """mmdet RPNHead: conv3x3 -> relu -> {1x1 cls (A), 1x1 reg (4A)}."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rpn_conv = _normal(nn.Conv2d(in_channels, feat_channels, 3,
                                          padding=1), 0.01, generator)
        self.rpn_cls = _normal(nn.Conv2d(feat_channels, num_anchors, 1),
                               0.01, generator)
        self.rpn_reg = _normal(nn.Conv2d(feat_channels, num_anchors * 4, 1),
                               0.01, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC [B, H, W, C] -> (cls [B, H, W, A], reg [B, H, W, 4A])."""
        t = conv2d_nhwc(x, self.rpn_conv.weight, self.rpn_conv.bias).relu()
        return (conv2d_nhwc(t, self.rpn_cls.weight, self.rpn_cls.bias),
                conv2d_nhwc(t, self.rpn_reg.weight, self.rpn_reg.bias))


@functools.lru_cache(maxsize=8)
def _anchors(featmap_sizes: tuple, strides: tuple, scale: float,
             scales_per_octave: int, ratios: tuple, device: str) -> list:
    return [torch.from_numpy(a).to(device) for a in pyramid_anchors(
        featmap_sizes, strides, octave_base_scale=scale,
        scales_per_octave=scales_per_octave, ratios=ratios)]


def rpn_proposals(
    level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    img_shape: Tuple[int, int],
    strides: Sequence[int] = RPN_STRIDES,
    scales: Sequence[float] = (8.0,),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    nms_pre: int = 1000,
    max_per_img: int = 1000,
    iou_threshold: float = 0.7,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level (cls [B, H, W, A], reg [B, H, W, 4A]) -> (proposals
    [B, R, 4], scores [B, R], valid [B, R]) fp32, R = max_per_img; mmdet
    ``RPNHead.get_bboxes`` at fixed shapes."""
    strides = tuple(strides[: len(level_outputs)])
    sizes = tuple(tuple(c.shape[1:3]) for c, _ in level_outputs)
    device = level_outputs[0][0].device
    anchors = _anchors(sizes, strides, float(scales[0]), len(scales),
                       tuple(ratios), str(device))
    b = level_outputs[0][0].shape[0]
    cand_boxes, cand_scores, cand_lvl = [], [], []
    for li, ((cls_map, reg_map), anc) in enumerate(zip(level_outputs,
                                                       anchors)):
        # (H, W, A) order, as the NHWC maps flatten
        scores = torch.sigmoid(cls_map.reshape(b, -1).float())
        deltas = reg_map.reshape(b, -1, 4).float()
        anc = anc.expand(b, -1, -1)
        if scores.shape[1] > nms_pre:
            top_scores, top = (t[:, :nms_pre] for t in sort_desc(scores))
            scores = top_scores
            deltas, anc = gather_rows(deltas, top), gather_rows(anc, top)
        cand_boxes.append(delta2bbox(anc, deltas, max_shape=img_shape))
        cand_scores.append(scores)
        cand_lvl.append(torch.full_like(scores, li))
    boxes = torch.cat(cand_boxes, 1)
    scores = torch.cat(cand_scores, 1)
    lvl = torch.cat(cand_lvl, 1)
    # levels never suppress each other: offset coordinates per level
    span = boxes.reshape(b, -1).amax(1) + 1.0
    idxs, valid = nms_fixed(boxes + (lvl * span[:, None])[..., None], scores,
                            iou_threshold, max_per_img)
    safe = idxs.clamp(min=0)
    return (torch.where(valid[..., None], gather_rows(boxes, safe), 0.0),
            torch.where(valid, gather_rows(scores, safe), 0.0), valid)


class Shared2FCBBoxHead(nn.Module):
    """mmdet Shared2FCBBoxHead: 2 x fc(1024) on the [C, s, s]-flattened RoI
    features, softmax cls over num_classes + 1 (background last), and
    class-specific box deltas."""

    def __init__(self, in_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 80,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            xavier_uniform(nn.Linear(in_channels * ROI_SIZE ** 2,
                                     fc_out_channels), generator),
            xavier_uniform(nn.Linear(fc_out_channels, fc_out_channels),
                           generator),
        ])
        self.fc_cls = _normal(nn.Linear(fc_out_channels, num_classes + 1),
                              0.01, generator)
        self.fc_reg = _normal(nn.Linear(fc_out_channels, num_classes * 4),
                              0.001, generator)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., s, s, C] NHWC RoI features -> (cls [..., K + 1],
        reg [..., 4K])."""
        x = roi_feats.movedim(-1, -3).flatten(-3)  # mmdet's [C, s, s] order
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class FCNMaskHead(nn.Module):
    """mmdet FCNMaskHead: 4 x conv3x3 -> 2x2 stride-2 deconv -> 1x1 logits."""

    def __init__(self, in_channels: int = 256, conv_out_channels: int = 256,
                 num_convs: int = 4, num_classes: int = 80,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, generator)
            for i in range(num_convs)])
        self.upsample = nn.ConvTranspose2d(conv_out_channels,
                                           conv_out_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)
        with torch.no_grad():
            for m in (self.upsample, self.conv_logits):
                m.weight.normal_(0.0, (2.0 / (m.weight[0].numel())) ** 0.5,
                                 generator=generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 14, 14, C] NHWC -> [..., 28, 28, K] logits."""
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for m in self.convs:
            x = conv2d_nhwc(x, m.conv.weight, m.conv.bias).relu()
        x = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.upsample.weight,
                               self.upsample.bias, stride=2).relu()
        x = F.conv2d(x, self.conv_logits.weight, self.conv_logits.bias)
        x = x.permute(0, 2, 3, 1)
        return x.reshape(*lead, *x.shape[1:])


class FasterRCNN(nn.Module):
    """Two-stage detector: backbone -> FPN -> RPN -> proposals -> RoIAlign
    -> bbox head.  ``forward`` returns the raw stage outputs; decode with
    :func:`rcnn_detections` / :func:`two_stage_predict`.  RoIAlign uses the
    grid ``roi_sampling_ratio`` (0 = the presets' adaptive grid; 2 = the
    JAX module's default)."""

    with_mask = False

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 80,
                 rpn_nms_pre: int = 1000, num_proposals: int = 1000,
                 roi_sampling_ratio: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rpn_nms_pre, self.num_proposals = rpn_nms_pre, num_proposals
        self.roi_sampling_ratio = roi_sampling_ratio
        self.backbone = ResNetMRLALight(list(layers), features_only=True,
                                        generator=generator)
        self.neck = FPN(out_channels=FPN_CHANNELS, generator=generator)
        self.rpn_head = RPNHead(FPN_CHANNELS, FPN_CHANNELS, 3, generator)
        self.roi_head = nn.Module()
        self.roi_head.bbox_head = Shared2FCBBoxHead(
            FPN_CHANNELS, num_classes=num_classes, generator=generator)
        if self.with_mask:
            self.roi_head.mask_head = FCNMaskHead(
                FPN_CHANNELS, num_classes=num_classes, generator=generator)

    @property
    def dtype(self) -> torch.dtype:
        return self.rpn_head.rpn_conv.weight.dtype

    def extract_feats(self, x: torch.Tensor) -> tuple:
        return self.neck(self.backbone(x))  # P2..P6

    def roi_feats(self, feats, rois, roi_valid, out_size: int = ROI_SIZE):
        """RoIAlign on P2..P5, in fp32 as the JAX module does (the features
        widened, the result narrowed to the module's dtype)."""
        return roi_align_patch(
            [f.float().contiguous() for f in feats[:4]], rois, roi_valid,
            strides=ROI_STRIDES, out_size=out_size,
            sampling_ratio=self.roi_sampling_ratio).to(self.dtype)

    def bbox_forward(self, feats, rois, roi_valid):
        """Second stage on given rois: (cls [B, R, K+1], reg [B, R, 4K])."""
        return self.roi_head.bbox_head(self.roi_feats(feats, rois, roi_valid))

    def mask_forward(self, mask_roi_feats: torch.Tensor) -> torch.Tensor:
        """[B, M, 14, 14, C] pooled features -> [B, M, 28, 28, K] logits."""
        return self.roi_head.mask_head(mask_roi_feats)

    def forward(self, x: torch.Tensor,
                proposals: Optional[torch.Tensor] = None,
                proposal_valid: Optional[torch.Tensor] = None) -> Dict:
        """[B, H, W, 3] NHWC images -> {rpn, proposals, proposal_valid, cls,
        reg, feats}."""
        feats = self.extract_feats(x.to(self.dtype))
        rpn_outs = tuple(self.rpn_head(f) for f in feats)
        if proposals is None:
            proposals, _, proposal_valid = rpn_proposals(
                rpn_outs, (x.shape[1], x.shape[2]), nms_pre=self.rpn_nms_pre,
                max_per_img=self.num_proposals)
        cls, reg = self.bbox_forward(feats, proposals, proposal_valid)
        return {"rpn": rpn_outs, "proposals": proposals,
                "proposal_valid": proposal_valid, "cls": cls, "reg": reg,
                "feats": feats}


class MaskRCNN(FasterRCNN):
    with_mask = True


def rcnn_detections(
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    cls_logits: torch.Tensor,
    bbox_deltas: torch.Tensor,
    img_shape: Tuple[int, int],
    score_thr: float = 0.05,
    iou_threshold: float = 0.5,
    max_per_img: int = 100,
    target_stds=RCNN_TARGET_STDS,
):
    """Second-stage decode, batched: softmax scores (background, the last
    column, dropped), class-specific delta decode, class-wise NMS.  Returns
    (boxes [B, M, 4], scores [B, M], labels [B, M], valid [B, M])."""
    b, p = cls_logits.shape[:2]
    num_classes = cls_logits.shape[-1] - 1
    scores = torch.softmax(cls_logits.float(), -1)[..., :-1]
    scores = scores * proposal_valid[..., None].to(scores.dtype)
    boxes = delta2bbox(proposals[:, :, None, :],
                       bbox_deltas.float().reshape(b, p, num_classes, 4),
                       stds=target_stds, max_shape=img_shape)
    return multiclass_nms_fixed(boxes, scores, score_thr, iou_threshold,
                                max_per_img)


def select_masks(mask_logits: torch.Tensor,
                 det_labels: torch.Tensor) -> torch.Tensor:
    """[B, M, 28, 28, K] logits -> [B, M, 28, 28] fp32 soft masks of each
    detection's class (class 0 for empty slots)."""
    lab = det_labels.clamp(min=0)[:, :, None, None, None]
    per_det = torch.gather(mask_logits, -1,
                           lab.expand(*mask_logits.shape[:-1], 1))[..., 0]
    return torch.sigmoid(per_det.float())


@torch.inference_mode()
def two_stage_predict(model: FasterRCNN, x: torch.Tensor,
                      score_thr: float = 0.05, iou_threshold: float = 0.5,
                      max_per_img: int = 100) -> Dict:
    """The test-time path: forward -> proposals -> detections (-> masks).
    Returns det_boxes / det_scores / det_labels / det_valid and, for
    ``MaskRCNN``, ``masks`` [B, M, 28, 28]."""
    out = model(x)
    img_shape = (x.shape[1], x.shape[2])
    det_boxes, det_scores, det_labels, det_valid = rcnn_detections(
        out["proposals"], out["proposal_valid"], out["cls"], out["reg"],
        img_shape, score_thr, iou_threshold, max_per_img)
    res = {"det_boxes": det_boxes, "det_scores": det_scores,
           "det_labels": det_labels, "det_valid": det_valid}
    if model.with_mask:
        mask_feats = model.roi_feats(out["feats"], det_boxes, det_valid,
                                     out_size=14)
        res["masks"] = select_masks(model.mask_forward(mask_feats),
                                    det_labels)
    return res
