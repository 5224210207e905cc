"""RetinaNet on the MRLA backbone, PyTorch: the port's counterpart of the
JAX package's ``detect/retinanet.py`` (the reference's RetinaNet graft,
configs/_base_/models/retinanet_r50mrlal_fpn.py):

  * ``RetinaHead``: one module applied to every pyramid level; four 3x3
    convs + ReLU on the classification branch and four on the regression
    branch, then ``retina_cls`` (A x num_classes logits, sigmoid focal) and
    ``retina_reg`` (A x 4 deltas); every conv Normal(0, 0.01), the
    classification bias at the focal prior -log((1 - p) / p), p = 0.01;
  * ``RetinaNet``: backbone (features only, no DropPath) -> FPN P3..P7
    (``start_level=1``, ``add_extra_convs='on_input'``) -> the head;
    anchors ``octave_base_scale=4``, ``scales_per_octave=3``, ratios
    (0.5, 1, 2), strides (8, 16, 32, 64, 128): A = 9 a cell;
  * ``get_bboxes``: the test config (``nms_pre=1000``, ``score_thr=0.05``,
    class-wise NMS at IoU 0.5, ``max_per_img=100``) at fixed shapes.

``state_dict`` keys are mmdet's (``backbone.*``, ``neck.*``,
``bbox_head.{cls,reg}_convs.{i}.conv.*``, ``bbox_head.retina_{cls,reg}.*``),
so an mmdet checkpoint loads as it is.

Layout: the NHWC head outputs [B, H, W, A * K] reshape to [B, H * W * A, K]
in the anchor order of ``detect/anchors.py`` (location-major, anchor-minor;
anchors ratio-major, scale-minor), as mmdet's ``permute(0, 2, 3, 1)
.reshape(-1, K)`` on its NCHW maps.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mrla_tpu_torch.detect.anchors import num_base_anchors
from mrla_tpu_torch.detect.anchors import level_anchors
from mrla_tpu_torch.detect.bbox import (
    delta2bbox,
    gather_rows,
    multiclass_nms_fixed,
    sort_desc,
)
from mrla_tpu_torch.detect.fpn import FPN
from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight
from mrla_tpu_torch.ops.common import conv2d_nhwc

RETINA_STRIDES = (8, 16, 32, 64, 128)


def focal_bias_init(prior_prob: float = 0.01) -> float:
    """mmdet ``bias_init_with_prob``: the bias that starts every sigmoid
    output at ``prior_prob``."""
    return -math.log((1 - prior_prob) / prior_prob)


def _normal_conv(cin: int, cout: int, generator, bias: float = 0.0
                 ) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.01, generator=generator)
        conv.bias.fill_(bias)
    return conv


def _tower(n: int, cin: int, feat: int, generator) -> nn.ModuleList:
    """``n`` mmdet ConvModules (``.conv`` only; the ReLU is applied in
    ``forward``), each Normal(0, 0.01) with a zero bias."""
    convs = nn.ModuleList()
    for i in range(n):
        m = nn.Module()
        m.conv = _normal_conv(cin if i == 0 else feat, feat, generator)
        convs.append(m)
    return convs


class RetinaHead(nn.Module):
    """Level-shared classification + regression head (mmdet RetinaHead)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_anchors: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cls_convs = _tower(stacked_convs, in_channels, feat_channels,
                                generator)
        self.reg_convs = _tower(stacked_convs, in_channels, feat_channels,
                                generator)
        self.retina_cls = _normal_conv(feat_channels,
                                       num_anchors * num_classes, generator,
                                       bias=focal_bias_init(0.01))
        self.retina_reg = _normal_conv(feat_channels, num_anchors * 4,
                                       generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC [B, H, W, C] -> (cls_score [B, H, W, A * K] logits,
        bbox_pred [B, H, W, A * 4])."""
        cls_feat, reg_feat = x, x
        for c, r in zip(self.cls_convs, self.reg_convs):
            cls_feat = conv2d_nhwc(cls_feat, c.conv.weight, c.conv.bias).relu()
            reg_feat = conv2d_nhwc(reg_feat, r.conv.weight, r.conv.bias).relu()
        return (conv2d_nhwc(cls_feat, self.retina_cls.weight,
                            self.retina_cls.bias),
                conv2d_nhwc(reg_feat, self.retina_reg.weight,
                            self.retina_reg.bias))


class RetinaNet(nn.Module):
    """Backbone + FPN (P3..P7) + RetinaHead; ``forward`` returns the
    per-level (cls, reg) maps.  ``remat`` recomputes each backbone block in
    the backward."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 80, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNetMRLALight(list(layers), features_only=True,
                                        generator=generator, remat=remat)
        self.neck = FPN(num_outs=5, start_level=1, add_extra_convs="on_input",
                        generator=generator)
        self.bbox_head = RetinaHead(num_classes,
                                    num_anchors=num_base_anchors(),
                                    generator=generator)

    def forward(self, x: torch.Tensor) -> tuple:
        """[B, H, W, 3] NHWC images -> ((cls, reg) of P3, .., of P7)."""
        return tuple(self.bbox_head(f) for f in self.neck(self.backbone(x)))


def get_bboxes(
    level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    img_shape: Tuple[int, int],
    strides: Sequence[int] = RETINA_STRIDES,
    octave_base_scale: float = 4.0,
    scales_per_octave: int = 3,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    nms_pre: int = 1000,
    score_thr: float = 0.05,
    iou_threshold: float = 0.5,
    max_per_img: int = 100,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
):
    """Head outputs -> detections (mmdet's test path), batched.

    Per level: sigmoid scores in fp32, the ``nms_pre`` anchors of the best
    max-class score (stable order: equal scores keep the lower index first,
    as ``jax.lax.top_k``), their deltas decoded on the level's anchors and
    clipped to ``img_shape`` (H, W); then class-wise NMS over the levels.
    Returns (boxes [B, M, 4], scores [B, M], labels [B, M] int64 (-1 where
    empty), valid [B, M] bool), M = ``max_per_img``."""
    anchors = level_anchors(level_outputs, strides, octave_base_scale,
                            scales_per_octave, ratios)
    b = level_outputs[0][0].shape[0]
    cand_boxes, cand_scores = [], []
    for (cls_map, reg_map), anc in zip(level_outputs, anchors):
        a = anc.shape[0] // (cls_map.shape[1] * cls_map.shape[2])
        num_c = cls_map.shape[-1] // a
        scores = torch.sigmoid(cls_map.reshape(b, -1, num_c).float())
        deltas = reg_map.reshape(b, -1, 4).float()
        anc = anc.expand(b, -1, -1)
        if scores.shape[1] > nms_pre:
            top = sort_desc(scores.amax(-1))[1][:, :nms_pre]
            scores = gather_rows(scores, top)
            deltas, anc = gather_rows(deltas, top), gather_rows(anc, top)
        cand_boxes.append(delta2bbox(anc, deltas, target_means, target_stds,
                                     max_shape=img_shape))
        cand_scores.append(scores)
    return multiclass_nms_fixed(torch.cat(cand_boxes, 1),
                                torch.cat(cand_scores, 1), score_thr,
                                iou_threshold, max_per_img)
