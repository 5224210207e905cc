"""Two-stage detection serving: the BN-folded MRLA trunk + FPN pyramid
export, and the whole Faster / Mask R-CNN test-time path on pre-cast
weights.

``prepare_detect_params`` folds and casts once: the trunk through
:func:`prepare_inference_params` (no head), the FPN convs, the RPN head
(its 1x1 objectness and regression convs concatenated into one conv), the
bbox head (the first fc's columns re-ordered from mmdet's [C, 7, 7]
flatten to the NHWC [7, 7, C] one, so the RoI features are flattened as
they lie) and, where present, the mask head.

``detect_forward`` is the pyramid export (the JAX package's
``serving.detect_forward``, with its ``start_level`` / ``add_extra_convs``):
the trunk with every block's MRLA tail in the epilogue or mega-tail kernel,
then the FPN; inference-identical to ``MRLABackboneFPN`` in eval (and to
RetinaNet's trunk and neck, whose extra convs ``prepare_detect_params``
takes from ``neck.fpn_convs`` past the laterals).

``two_stage_detections`` is what the JAX detection daemon jits for a
two-stage preset (``serving/server.py``'s ``fwd``), without the HTTP
layer: pyramid, RPN head on P2..P6, proposals, RoIAlign on P2..P5 through
the CUDA kernel (reading the bf16 pyramid, writing the bf16 head input),
bbox head, decode and class-wise NMS in fp32, and for the mask preset a
second RoIAlign at 14 x 14 on the detections, the mask head and each
detection's sigmoid mask.  It returns the daemon's tuple (boxes, scores,
labels, valid[, masks]).  Each stage runs through a ``stage`` hook,
``stage(name, fn, *args, **kwargs)``, which by default just calls
``fn``: ``profile_serving --preset`` passes one that records the stages of
one forward to time each alone, and ``chip_smoke.py`` one that keeps the
RoIAlign stages' inputs, so both read the pipeline that is served.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.detect import fpn as fpn_mod
from mrla_tpu_torch.detect.configs import PRESETS
from mrla_tpu_torch.detect.two_stage import (
    ROI_SIZE,
    ROI_STRIDES,
    rcnn_detections,
    rpn_proposals,
    run_stage,
    select_masks,
)
from mrla_tpu_torch.kernels.roialign_patch import roi_align_patch
from mrla_tpu_torch.ops.common import conv2d_nhwc
from mrla_tpu_torch.serving.microbatch import chains
from mrla_tpu_torch.serving.resnet_mrlal import (
    _trunk_impl,
    prepare_inference_params,
)


def prepare_detect_params(
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    layers: Sequence[int] = (3, 4, 6, 3),
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Dict:
    """An mmdet-keyed detector (``FasterRCNN`` / ``MaskRCNN`` /
    ``RetinaNet`` / ``MRLABackboneFPN``, or its ``state_dict``) -> serving
    params on ``device``: {"trunk", "neck"[, "rpn_head", "bbox_head"[,
    "mask_head"]]}, weights and biases in ``dtype``.  The R-CNN heads are
    taken where present; RetinaNet's head is not (its trunk and neck
    serve through :func:`detect_forward`)."""
    dev = resolve_device(device)
    src = (model_or_state_dict.state_dict()
           if isinstance(model_or_state_dict, nn.Module)
           else model_or_state_dict)
    sd = {k.removeprefix("module."): v.detach().to("cpu", torch.float32)
          for k, v in src.items()}

    def conv(prefix: str):
        return (sd[f"{prefix}.weight"].to(dev, dtype).contiguous(
                    memory_format=torch.channels_last),
                sd[f"{prefix}.bias"].to(dev, dtype))

    def dense(prefix: str, weight: Optional[torch.Tensor] = None):
        w = sd[f"{prefix}.weight"] if weight is None else weight
        return w.to(dev, dtype).contiguous(), sd[f"{prefix}.bias"].to(dev,
                                                                      dtype)

    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    out: Dict = {"trunk": prepare_inference_params(
        backbone, layers, dtype, dev, with_head=False)}
    n_lat = len({k.split(".")[2] for k in sd
                 if k.startswith("neck.lateral_convs.")})
    n_fpn = len({k.split(".")[2] for k in sd
                 if k.startswith("neck.fpn_convs.")})
    out["neck"] = {
        "lateral": [conv(f"neck.lateral_convs.{i}.conv")
                    for i in range(n_lat)],
        "fpn": [conv(f"neck.fpn_convs.{i}.conv") for i in range(n_lat)],
        "extra": [conv(f"neck.fpn_convs.{i}.conv")
                  for i in range(n_lat, n_fpn)],
    }
    if "rpn_head.rpn_conv.weight" in sd:
        w_cls = sd["rpn_head.rpn_cls.weight"]
        w_reg = sd["rpn_head.rpn_reg.weight"]
        out["rpn_head"] = {
            "conv": conv("rpn_head.rpn_conv"),
            "out": (torch.cat([w_cls, w_reg]).to(dev, dtype).contiguous(
                        memory_format=torch.channels_last),
                    torch.cat([sd["rpn_head.rpn_cls.bias"],
                               sd["rpn_head.rpn_reg.bias"]]).to(dev, dtype)),
            "num_anchors": w_cls.shape[0],
        }
    pre = "roi_head.bbox_head."
    if f"{pre}fc_cls.weight" in sd:
        w0 = sd[f"{pre}shared_fcs.0.weight"]
        s = ROI_SIZE
        w0 = w0.reshape(w0.shape[0], -1, s, s).permute(0, 2, 3, 1).reshape(
            w0.shape[0], -1)
        out["bbox_head"] = {
            "fc0": dense(f"{pre}shared_fcs.0", w0),
            "fc1": dense(f"{pre}shared_fcs.1"),
            "cls": dense(f"{pre}fc_cls"),
            "reg": dense(f"{pre}fc_reg"),
        }
    pre = "roi_head.mask_head."
    if f"{pre}conv_logits.weight" in sd:
        n_convs = len({k.split(".")[3] for k in sd
                       if k.startswith(f"{pre}convs.")})
        out["mask_head"] = {
            "convs": [conv(f"{pre}convs.{i}.conv") for i in range(n_convs)],
            "upsample": (sd[f"{pre}upsample.weight"].to(dev, dtype),
                         sd[f"{pre}upsample.bias"].to(dev, dtype)),
            "logits": conv(f"{pre}conv_logits"),
        }
    return out


@torch.inference_mode()
def detect_forward(serving_params: Dict, x: torch.Tensor,
                   layers: Sequence[int] = (3, 4, 6, 3),
                   stage=run_stage, microbatch: int = 0,
                   start_level: int = 0,
                   add_extra_convs: Optional[str] = None) -> tuple:
    """[B, H, W, 3] images on the params' device -> the pyramid, NHWC in
    the serving dtype: P2..P6 by default, P3..P7 with RetinaNet's neck
    (``start_level=1, add_extra_convs="on_input"``; the params' neck then
    holds its extra convs).  ``microbatch`` > 0 runs trunk and FPN as
    chains of that many images, one after another
    (``serving/microbatch.py``; 0 serves the batch unsplit)."""
    def one(images):
        feats = stage("backbone", _trunk_impl, serving_params["trunk"],
                      images, layers, 32)
        return stage("FPN", fpn_mod.fpn_forward, serving_params["neck"],
                     feats, 5, start_level, add_extra_convs)

    parts = chains(x, microbatch)
    if parts is None:
        return one(x)
    pyramids = [one(part) for part in parts]
    return tuple(torch.cat(level) for level in zip(*pyramids))


def rpn_head(p: Dict, feats: Sequence[torch.Tensor]) -> list:
    """The RPN head on every level: [(cls [B, H, W, A], reg [B, H, W, 4A])]."""
    a = p["num_anchors"]
    outs = []
    for f in feats:
        t = conv2d_nhwc(f, *p["conv"]).relu_()
        y = conv2d_nhwc(t, *p["out"])
        outs.append((y[..., :a], y[..., a:]))
    return outs


def bbox_head(p: Dict, roi_feats: torch.Tensor):
    """[B, R, s, s, C] RoI features -> (cls [B, R, K + 1], reg [B, R, 4K]),
    in the weights' dtype."""
    x = F.linear(roi_feats.flatten(-3), *p["fc0"]).relu_()
    x = F.linear(x, *p["fc1"]).relu_()
    return F.linear(x, *p["cls"]), F.linear(x, *p["reg"])


def mask_head(p: Dict, mask_feats: torch.Tensor) -> torch.Tensor:
    """[B, M, 14, 14, C] -> [B, M, 28, 28, K] mask logits."""
    lead = mask_feats.shape[:2]
    x = mask_feats.reshape(-1, *mask_feats.shape[2:])
    for w in p["convs"]:
        x = conv2d_nhwc(x, *w).relu_()
    x = F.conv_transpose2d(x.permute(0, 3, 1, 2), *p["upsample"],
                           stride=2).relu_()
    x = conv2d_nhwc(x.permute(0, 2, 3, 1), *p["logits"])
    return x.reshape(*lead, *x.shape[1:])


def roi_feats(feats: Sequence[torch.Tensor], rois: torch.Tensor,
              roi_valid: torch.Tensor, out_size: int) -> torch.Tensor:
    """RoIAlign on P2..P5 through the kernel, in the pyramid's dtype, on
    the presets' adaptive grid (sampling_ratio=0,
    faster_rcnn_r50mrlal_fpn.py:40)."""
    return roi_align_patch(list(feats[:4]), rois, roi_valid,
                           strides=ROI_STRIDES, out_size=out_size,
                           sampling_ratio=0)


@torch.inference_mode()
def two_stage_detections(
    serving_params: Dict,
    x: torch.Tensor,
    preset: str = "faster_rcnn_r50mrlal_fpn_1x_coco",
    score_thr: float = 0.05,
    max_per_img: int = 100,
    num_proposals: int = 1000,
    rpn_nms_pre: int = 1000,
    layers: Optional[Sequence[int]] = None,
    stage=run_stage,
) -> tuple:
    """[B, H, W, 3] images -> (det_boxes [B, M, 4], det_scores [B, M],
    det_labels [B, M], det_valid [B, M][, masks [B, M, 28, 28]]), M =
    ``max_per_img``, boxes and scores fp32.  ``preset`` picks the backbone
    depth (unless ``layers`` is given) and, for a ``mask_rcnn`` preset, the
    masks.  Class-wise NMS at IoU 0.5, as the presets' test config."""
    p = PRESETS[preset]
    if p.add_extra_convs is not None:
        raise NotImplementedError(f"{preset}: only the two-stage presets "
                                  "are ported")
    if p.with_mask and "mask_head" not in serving_params:
        raise ValueError(f"{preset} needs a mask head in the params")
    layers = tuple(layers or p.backbone_layers)
    img_shape = (x.shape[1], x.shape[2])
    feats = detect_forward(serving_params, x, layers, stage)
    rpn_outs = stage("RPN head", rpn_head, serving_params["rpn_head"], feats)
    proposals, _, valid = stage(
        "proposals (top-k, decode, NMS)", rpn_proposals, rpn_outs, img_shape,
        nms_pre=rpn_nms_pre, max_per_img=num_proposals)
    rois = stage("RoIAlign 7x7", roi_feats, feats, proposals, valid,
                 ROI_SIZE)
    cls, reg = stage("box head", bbox_head, serving_params["bbox_head"], rois)
    dets = stage("decode + class-wise NMS", rcnn_detections, proposals, valid,
                 cls, reg, img_shape, score_thr, max_per_img=max_per_img)
    if not p.with_mask:
        return dets
    det_boxes, _, det_labels, det_valid = dets
    mask_rois = stage("RoIAlign 14x14", roi_feats, feats, det_boxes,
                      det_valid, 2 * ROI_SIZE)
    masks = stage("mask head + select",
                  lambda f, lab: select_masks(
                      mask_head(serving_params["mask_head"], f), lab),
                  mask_rois, det_labels)
    return (*dets, masks)
