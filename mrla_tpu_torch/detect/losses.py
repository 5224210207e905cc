"""RetinaNet training loss: sigmoid focal + L1, PyTorch (the port's
counterpart of the JAX package's ``detect/losses.py``), for the
reference's bbox_head config (retinanet_r50mrlal_fpn.py:37-44):
``FocalLoss(use_sigmoid=True, gamma=2.0, alpha=0.25)`` and ``L1Loss``.

  * focal: ``w = (α·t + (1−α)(1−t)) · (t(1−p) + (1−t)p)^γ``, ``loss = w ·
    BCE(logit, t)`` elementwise over all C class channels with one-hot
    targets (background anchors: all-zero rows), BCE in its stable form;
  * both terms divide by ``avg_factor = max(num_pos over the batch, 1)``,
    the global batch's under data parallelism (summed over the ranks, with
    no gradient through it, as the JAX step's under GSPMD);
  * L1 on encoded deltas, positive anchors only.

Logits are taken in fp32 whatever the forward's dtype (``--bf16``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from mrla_tpu_torch.detect.anchors import level_anchors
from mrla_tpu_torch.detect.targets import anchor_targets
from mrla_tpu_torch.parallel import launch


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Elementwise focal loss on raw logits; ``targets`` in {0, 1}."""
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return alpha_t * (1 - p_t) ** gamma * ce


def retinanet_loss(
    level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    octave_base_scale: float = 4.0,
    scales_per_octave: int = 3,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    alpha: float = 0.25,
    gamma: float = 2.0,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.4,
    min_pos_iou: float = 0.0,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
) -> Dict[str, torch.Tensor]:
    """The batch's loss of the head outputs (per level (cls [B, H, W, A*C],
    reg [B, H, W, A*4]) from ``RetinaNet``); gt_boxes [B, G, 4] padded,
    gt_labels [B, G], gt_valid [B, G].  Returns {'loss', 'loss_cls',
    'loss_bbox', 'num_pos'}."""
    anchors = torch.cat(level_anchors(level_outputs, strides,
                                      octave_base_scale, scales_per_octave,
                                      ratios))
    b = level_outputs[0][0].shape[0]
    cls_logits = torch.cat([c.reshape(b, -1, num_classes).float()
                            for c, _ in level_outputs], 1)  # [B, N, C]
    bbox_preds = torch.cat([r.reshape(b, -1, 4).float()
                            for _, r in level_outputs], 1)  # [B, N, 4]
    with torch.no_grad():
        labels, label_w, bbox_t, bbox_w, num_pos = anchor_targets(
            anchors, gt_boxes, gt_labels, gt_valid, num_classes,
            pos_iou_thr, neg_iou_thr, min_pos_iou, target_means,
            target_stds)
    avg_factor = launch.global_sum(num_pos.sum().float()).clamp(min=1.0)
    # one-hot over C + 1 columns, the background's dropped: its rows are 0
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    loss_cls = (sigmoid_focal_loss(cls_logits, onehot, alpha, gamma)
                * label_w[..., None]).sum() / avg_factor
    loss_bbox = ((bbox_preds - bbox_t).abs().sum(-1)
                 * bbox_w).sum() / avg_factor
    return {"loss": loss_cls + loss_bbox, "loss_cls": loss_cls,
            "loss_bbox": loss_bbox, "num_pos": num_pos.sum()}
