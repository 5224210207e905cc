"""Two-stage training: RPN loss, random sampling, R-CNN targets and losses,
PyTorch.

The port's counterpart of the JAX package's ``detect/two_stage_train.py``,
the reference's train_cfg (faster_rcnn_r50mrlal_fpn.py:58-96,
mask_rcnn_r50mrlal_fpn.py:95-110):

  * RPN: MaxIoUAssigner(pos .7 / neg .3 / min_pos .3, low-quality on),
    RandomSampler(256, pos_fraction .5), binary sigmoid CE + L1, both over
    the sampled count;
  * R-CNN: proposals and gt (``add_gt_as_proposals``), MaxIoUAssigner
    (.5 / .5 / .5, low-quality off for Faster, on for Mask),
    RandomSampler(512, pos_fraction .25), softmax CE over K + 1 (background
    last) + class-specific L1 on encoded deltas (stds .1, .1, .2, .2), over
    the sampled count;
  * mask: BCE of the positive rois' own-class 28 x 28 logits against the gt
    masks cropped to the roi by the same aligned RoIAlign (one bilinear
    sample a pixel), binarized at 0.5.

Fixed shapes, as in the JAX package: a sampler gives every candidate a
random priority, sorts the candidates positives first and takes a static
``num`` prefix; rows past the sampled count weigh zero.

Random draws: every sampler takes its uniforms as tensors.  The JAX
functions draw them from keys; here :func:`faster_rcnn_train_loss` takes
either a ``torch.Generator`` (and draws them) or the uniforms themselves
(``{"rpn": [B, 2, N], "rcnn": [B, 3, G + R]}``), so that a test can hand
both packages the same numbers.  Sorts are stable, as ``jnp.argsort`` is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from mrla_tpu_torch.detect.anchors import device_anchors
from mrla_tpu_torch.detect.bbox import bbox2delta, gather_rows
from mrla_tpu_torch.detect.targets import max_iou_assign
from mrla_tpu_torch.detect.two_stage import (
    RCNN_TARGET_STDS,
    RPN_STRIDES,
    rpn_proposals,
    run_stage,
)
from mrla_tpu_torch.kernels.roialign_patch import roi_align_patch

Uniforms = Union[torch.Generator, Mapping[str, torch.Tensor]]


def _rank_among(mask: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """Rank of each True entry among the True entries of its row, in the
    order of ``rand`` (False entries rank after every True one)."""
    key = torch.where(mask, rand, torch.full_like(rand, 2.0))
    order = torch.argsort(key, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(
        order.shape[-1], device=order.device).expand_as(order))
    return ranks


def random_sample(pos: torch.Tensor, neg: torch.Tensor, num: int,
                  pos_fraction: float, u_pos: torch.Tensor,
                  u_neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mmdet RandomSampler on [B, N] masks: up to ``num * pos_fraction``
    random positives, negatives fill the rest (``neg_pos_ub=-1``).  u_pos,
    u_neg [B, N] uniforms.  Returns (pos_sampled, neg_sampled) masks."""
    pos_budget = pos.sum(-1).clamp(max=int(num * pos_fraction))
    pos_s = pos & (_rank_among(pos, u_pos) < pos_budget[:, None])
    neg_budget = num - pos_s.sum(-1)
    neg_s = neg & (_rank_among(neg, u_neg) < neg_budget[:, None])
    return pos_s, neg_s


def rpn_anchors(featmap_sizes, device, strides: Sequence[int] = RPN_STRIDES,
                scales: Sequence[float] = (8.0,),
                ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> torch.Tensor:
    """All anchors of the pyramid [N, 4], levels in order, each level in
    (H, W, A) order as the NHWC maps flatten."""
    return torch.cat(device_anchors(
        tuple(tuple(s) for s in featmap_sizes),
        tuple(strides[: len(featmap_sizes)]), float(scales[0]), len(scales),
        tuple(ratios), str(device)))


def rpn_loss(
    level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    uniforms: torch.Tensor,
    num_samples: int = 256,
    pos_fraction: float = 0.5,
    pos_iou_thr: float = 0.7,
    neg_iou_thr: float = 0.3,
    min_pos_iou: float = 0.3,
) -> Dict[str, torch.Tensor]:
    """First-stage loss over a batch (class-agnostic objectness + L1).
    level_outputs: per level (cls [B, H, W, A], reg [B, H, W, 4A]);
    uniforms [B, 2, N]: the sampler's draws for positives and negatives."""
    b = level_outputs[0][0].shape[0]
    anchors = rpn_anchors([c.shape[1:3] for c, _ in level_outputs],
                          gt_boxes.device)
    cls_logits = torch.cat([c.reshape(b, -1).float()
                            for c, _ in level_outputs], 1)  # [B, N]
    bbox_preds = torch.cat([r.reshape(b, -1, 4).float()
                            for _, r in level_outputs], 1)
    assigned = max_iou_assign(anchors, gt_boxes, gt_valid, pos_iou_thr,
                              neg_iou_thr, min_pos_iou)
    pos_s, neg_s = random_sample(assigned > 0, assigned == 0, num_samples,
                                 pos_fraction, uniforms[:, 0], uniforms[:, 1])
    gt_idx = (assigned - 1).clamp(min=0)
    target = pos_s.float()
    # mask before use: a padded zero-area gt gives -inf deltas (log 0)
    deltas = torch.where(
        pos_s[..., None],
        bbox2delta(anchors.expand(b, -1, -1), gather_rows(gt_boxes, gt_idx)),
        0.0)
    samp_w = (pos_s | neg_s).float()
    avg = samp_w.sum().clamp(min=1.0)
    ce = (cls_logits.clamp(min=0) - cls_logits * target
          + torch.log1p(torch.exp(-cls_logits.abs())))
    loss_cls = (ce * samp_w).sum() / avg
    loss_bbox = ((bbox_preds - deltas).abs().sum(-1) * pos_s).sum() / avg
    return {"loss_rpn_cls": loss_cls, "loss_rpn_bbox": loss_bbox,
            "num_pos": pos_s.sum()}


def rcnn_targets(
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    uniforms: torch.Tensor,
    num: int = 512,
    pos_fraction: float = 0.25,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.5,
    min_pos_iou: float = 0.5,
    match_low_quality: bool = False,
    add_gt_as_proposals: bool = True,
    target_stds=RCNN_TARGET_STDS,
) -> Dict[str, torch.Tensor]:
    """Second-stage sampled rois and targets for a batch.  uniforms
    [B, 3, M] (M = G + R with gt added as proposals): the sampler's draws
    for positives and negatives, and the priority that orders the sampled
    rows.  Returns rois [B, num, 4], roi_valid, labels (``num_classes`` =
    background), label_weights, bbox_targets [B, num, 4], bbox_weights,
    gt_index: positives first in the static prefix, so the mask branch can
    take its rois from the front."""
    if add_gt_as_proposals:
        rois = torch.cat([gt_boxes, proposals], 1)
        valid = torch.cat([gt_valid, proposal_valid], 1)
    else:
        rois, valid = proposals, proposal_valid
    assigned = max_iou_assign(rois, gt_boxes, gt_valid, pos_iou_thr,
                              neg_iou_thr, min_pos_iou,
                              match_low_quality=match_low_quality)
    assigned = torch.where(valid, assigned, -1)
    pos_s, neg_s = random_sample(assigned > 0, assigned == 0, num,
                                 pos_fraction, uniforms[:, 0], uniforms[:, 1])
    u = uniforms[:, 2]
    order_key = torch.where(pos_s, u, torch.where(neg_s, 1.0 + u, 3.0))
    take = torch.argsort(order_key, dim=-1, stable=True)[:, :num]
    rois_t = gather_rows(rois, take)
    assigned_t = torch.gather(assigned, 1, take)
    sampled_t = torch.gather(pos_s | neg_s, 1, take)
    pos_t = torch.gather(pos_s, 1, take)
    gt_idx = (assigned_t - 1).clamp(min=0)
    labels = torch.where(pos_t, torch.gather(gt_labels.long(), 1, gt_idx),
                         num_classes)
    deltas = bbox2delta(rois_t, gather_rows(gt_boxes, gt_idx),
                        stds=target_stds)
    return {
        "rois": rois_t,
        "roi_valid": sampled_t,
        "labels": labels,
        "label_weights": sampled_t.float(),
        "bbox_targets": torch.where(pos_t[..., None], deltas, 0.0),
        "bbox_weights": pos_t.float(),
        "gt_index": gt_idx,
    }


def rcnn_loss(cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
              targets: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Softmax CE (background = the last class) + class-specific L1.
    cls_logits [B, R, K + 1], bbox_preds [B, R, 4K] from
    ``FasterRCNN.bbox_forward`` on ``targets["rois"]``."""
    num_classes = cls_logits.shape[-1] - 1
    labels = targets["labels"]
    lw = targets["label_weights"]
    avg = lw.sum().clamp(min=1.0)
    logp = F.log_softmax(cls_logits.float(), -1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss_cls = (nll * lw).sum() / avg
    reg = bbox_preds.float().reshape(*bbox_preds.shape[:-1], num_classes, 4)
    lab = labels.clamp(max=num_classes - 1)  # background rows weigh 0
    reg_own = torch.gather(
        reg, -2, lab[..., None, None].expand(*lab.shape, 1, 4))[..., 0, :]
    loss_bbox = ((reg_own - targets["bbox_targets"]).abs().sum(-1)
                 * targets["bbox_weights"]).sum() / avg
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}


def mask_targets(targets: Mapping[str, torch.Tensor], gt_masks: torch.Tensor,
                 mask_size: int = 28) -> torch.Tensor:
    """Each roi's gt mask cropped to the roi -> [B, R, S, S] in {0, 1}: one
    RoIAlign of the gt masks as channels (one level, stride 1, one bilinear
    sample a pixel), the roi's own gt channel, binarized at 0.5.  The canvas
    is fp32 (masks are exactly 0 or 1): the kernel's output has its input's
    dtype, and the 0.5 threshold needs the fp32 sum the JAX package takes
    (a bf16 output would round values within 2^-10 below 0.5 up to it).
    The gt axis is padded to a multiple of 8, the kernel's channel step."""
    b, g = gt_masks.shape[:2]
    m4 = gt_masks.permute(0, 2, 3, 1).float()
    pad = -g % 8
    if pad:
        m4 = F.pad(m4, (0, pad))
    crops = roi_align_patch([m4.contiguous()], targets["rois"], None,
                            strides=(1,), out_size=mask_size,
                            sampling_ratio=1, finest_scale=1e9)
    idx = targets["gt_index"][:, :, None, None, None].expand(
        *crops.shape[:-1], 1)
    return (torch.gather(crops, -1, idx)[..., 0] >= 0.5).float()


def mask_loss(mask_logits: torch.Tensor, targets: Mapping[str, torch.Tensor],
              gt_masks: torch.Tensor, mask_size: int = 28) -> torch.Tensor:
    """BCE of each positive roi's own-class mask logits against its gt mask
    cropped to the roi (:func:`mask_targets`).  mask_logits [B, R, S, S, K]
    from ``mask_forward`` on the rois of ``targets`` (positives at the
    front); gt_masks [B, G, H, W] in {0, 1} at image resolution."""
    mt = mask_targets(targets, gt_masks, mask_size)
    labels = targets["labels"].clamp(max=mask_logits.shape[-1] - 1)
    own = torch.gather(
        mask_logits.float(), -1,
        labels[:, :, None, None, None].expand(*mask_logits.shape[:-1], 1)
    )[..., 0]  # [B, R, S, S]
    ce = (own.clamp(min=0) - own * mt
          + torch.log1p(torch.exp(-own.abs()))).mean(dim=(-1, -2))
    w = targets["bbox_weights"]  # positives only
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def _uniforms(rand: Uniforms, key: str, shape, device) -> torch.Tensor:
    if isinstance(rand, torch.Generator):
        return torch.rand(shape, generator=rand, device=device)
    u = rand[key]
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"uniforms[{key!r}] must be {tuple(shape)}, got "
                         f"{tuple(u.shape)}")
    return u.to(device=device, dtype=torch.float32)


def faster_rcnn_train_loss(
    model,
    x: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    rand: Uniforms,
    gt_masks: Optional[torch.Tensor] = None,
    rcnn_num: int = 512,
    rpn_num: int = 256,
    mask_num: Optional[int] = None,
    stage=run_stage,
) -> Tuple[torch.Tensor, Dict, Dict]:
    """One training forward: RPN loss + sampled R-CNN loss (+ mask loss)
    -> (total loss, the loss terms and num_pos, the sampled R-CNN targets).

    ``model``: a ``FasterRCNN`` / ``MaskRCNN`` (in eval mode for the
    presets' frozen BN).  ``rand``: a ``torch.Generator`` on ``x``'s device
    or the uniforms (see the module's docstring).  Every stage runs through
    ``stage(name, fn, *args)`` (default: call it), so that a profiler or a
    check can see each stage's inputs."""
    dev = x.device
    feats, rpn_outs = model.rpn_forward(x, stage=stage)
    b = x.shape[0]
    n_anchors = sum(c.shape[1] * c.shape[2] * c.shape[3] for c, _ in rpn_outs)
    losses = stage("RPN targets + loss", rpn_loss, rpn_outs, gt_boxes,
                   gt_valid, _uniforms(rand, "rpn", (b, 2, n_anchors), dev),
                   num_samples=rpn_num)
    with torch.no_grad():
        proposals, _, prop_valid = stage(
            "proposals", rpn_proposals,
            tuple((c.detach(), r.detach()) for c, r in rpn_outs),
            (x.shape[1], x.shape[2]), nms_pre=model.rpn_nms_pre,
            max_per_img=model.num_proposals, iou_threshold=0.7)
        m = gt_boxes.shape[1] + proposals.shape[1]
        targets = stage(
            "R-CNN targets", rcnn_targets, proposals, prop_valid, gt_boxes,
            gt_labels, gt_valid, model.num_classes,
            _uniforms(rand, "rcnn", (b, 3, m), dev), num=rcnn_num,
            match_low_quality=model.with_mask)  # faster: off; mask: on
    roi = stage("RoIAlign 7x7", model.roi_feats, feats, targets["rois"],
                targets["roi_valid"])
    cls, reg = stage("box head", model.roi_head.bbox_head, roi)
    losses.update(stage("R-CNN loss", rcnn_loss, cls, reg, targets))
    total = (losses["loss_rpn_cls"] + losses["loss_rpn_bbox"]
             + losses["loss_cls"] + losses["loss_bbox"])
    if model.with_mask and gt_masks is not None:
        # mmdet trains the mask head on the sampled positives only; they
        # lead the prefix, and a prefix of the positive budget covers them
        # (bbox_weights zero any negative that slips in)
        mn = mask_num if mask_num is not None else max(1, rcnn_num // 4)
        mn = min(mn, targets["rois"].shape[1])
        t_mask = {k: v[:, :mn] for k, v in targets.items()}
        mroi = stage("mask RoIAlign 14x14", model.roi_feats, feats,
                     t_mask["rois"], t_mask["roi_valid"], 14)
        mask_logits = stage("mask head", model.mask_forward, mroi)
        losses["loss_mask"] = stage("mask loss", mask_loss, mask_logits,
                                    t_mask, gt_masks)
        total = total + losses["loss_mask"]
    losses["loss"] = total
    return total, losses, targets
