"""Anchor / roi assignment (MMDetection ``MaxIoUAssigner``), PyTorch.

The port's counterpart of the JAX package's ``detect/targets.py``
(``max_iou_assign``, ``anchor_targets``), batched over a leading image
axis.  Per anchor:

  1. ``-1`` (ignore) everywhere, then ``0`` (background) where the anchor's
     best IoU over all gts is below ``neg_iou_thr``;
  2. ``gt_index + 1`` where the best IoU >= ``pos_iou_thr`` (the first gt
     of the best IoU, as ``argmax`` picks it);
  3. low-quality matching: for each gt in index order, every anchor tying
     the gt's own best IoU is (re)assigned to it when that best IoU >=
     ``min_pos_iou``, so a later gt wins a tie.  Here all gts at once: the
     largest index among the gts that take an anchor is the one the loop
     would leave.

Gt boxes arrive padded to a static [G, 4] with a ``gt_valid`` mask; padded
rows get IoU -1, so they never win, and an image without valid gts makes
every anchor background.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mrla_tpu_torch.detect.bbox import bbox2delta, bbox_overlaps, gather_rows


def max_iou_assign(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.4,
    min_pos_iou: float = 0.0,
    match_low_quality: bool = True,
) -> torch.Tensor:
    """anchors [N, 4] or [B, N, 4], gt_boxes [B, G, 4] (padded), gt_valid
    [B, G] bool -> assigned [B, N] int64: -1 ignore / 0 background / g + 1
    matched to gt g."""
    overlaps = bbox_overlaps(gt_boxes, anchors)  # [B, G, N]
    overlaps = torch.where(gt_valid[..., None], overlaps,
                           torch.full_like(overlaps, -1.0))
    anchor_max = overlaps.amax(dim=-2)  # [B, N]
    anchor_argmax = overlaps.argmax(dim=-2)  # the first of equal maxima
    assigned = torch.full_like(anchor_argmax, -1)
    assigned = torch.where(anchor_max < neg_iou_thr, 0, assigned)
    assigned = torch.where(anchor_max >= pos_iou_thr, anchor_argmax + 1,
                           assigned)
    if match_low_quality:
        gt_max = overlaps.amax(dim=-1, keepdim=True)  # [B, G, 1]
        take = (gt_valid[..., None] & (gt_max >= min_pos_iou)
                & (overlaps == gt_max))  # [B, G, N]
        index = torch.arange(1, overlaps.shape[-2] + 1,
                             device=overlaps.device)[:, None]
        last = (take * index).amax(dim=-2)  # the highest gt + 1, or 0
        assigned = torch.where(last > 0, last, assigned)
    return assigned


def anchor_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.4,
    min_pos_iou: float = 0.0,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
) -> Tuple[torch.Tensor, ...]:
    """Dense targets of a batch (mmdet ``AnchorHead._get_targets_single``).
    anchors [N, 4], gt_boxes [B, G, 4] padded, gt_labels [B, G], gt_valid
    [B, G].  Returns (labels [B, N] int64: the gt's class on positives,
    ``num_classes`` elsewhere; label_weights [B, N]: 1 on positives and
    negatives, 0 on ignored anchors; bbox_targets [B, N, 4]: encoded
    deltas on positives, 0 elsewhere; bbox_weights [B, N]; num_pos [B])."""
    assigned = max_iou_assign(anchors, gt_boxes, gt_valid, pos_iou_thr,
                              neg_iou_thr, min_pos_iou)
    pos = assigned > 0
    gt_idx = (assigned - 1).clamp(min=0)
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         num_classes)
    label_weights = (assigned >= 0).float()
    deltas = bbox2delta(anchors.expand(gt_boxes.shape[0], -1, -1),
                        gather_rows(gt_boxes, gt_idx), target_means,
                        target_stds)
    bbox_targets = torch.where(pos[..., None], deltas, 0.0)
    return labels, label_weights, bbox_targets, pos.float(), pos.sum(-1)
