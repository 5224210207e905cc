"""Box coding, IoU and fixed-shape NMS (MMDetection semantics), PyTorch.

The port's counterpart of the JAX package's ``detect/bbox.py``:
``DeltaXYWHBBoxCoder`` encode / decode (with ``wh_ratio_clip``), pairwise
IoU, and greedy NMS that returns exactly ``max_out`` slots and a validity
mask, class-wise through mmdet's coordinate-offset trick, and soft-NMS.
Every function takes a leading batch dimension or none.

NMS: the JAX package runs ``max_out`` steps of argmax-and-suppress.  Here
the same greedy result comes from the candidates sorted by score (stable,
so equal scores keep the lower index first, as ``argmax`` does) and the
fixed point of

    keep[j] = present[j] and no i < j with keep[i] and IoU(i, j) > thr

(Cluster-NMS).  The greedy keep vector is that equation's only fixed point
(by induction on j), and each iteration, started from ``present``, makes
at least one more entry final, so the loop ends; it stops when an
iteration changes nothing, usually after a few.  Each iteration is one
batched product of the keep vector with the [N, N] suppression matrix, in
place of thousands of small launches.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas w.r.t. proposals; both
    [..., 4] (x1, y1, x2, y2).  Inverse of :func:`delta2bbox`."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    return (deltas - _vec(means, deltas)) / _vec(stds, deltas)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0),
               max_shape: Tuple[int, int] | None = None,
               wh_ratio_clip: float = 16.0 / 1000.0) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on boxes -> (x1, y1, x2, y2).

    rois [..., 4] and deltas [..., 4] broadcast; dw / dh are clamped to
    ``|log(wh_ratio_clip)|`` and the boxes clipped to ``max_shape`` (H, W)
    when it is given."""
    d = deltas * _vec(stds, deltas) + _vec(means, deltas)
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if max_shape is not None:
        h, w = max_shape
        x1 = x1.clamp(0, w)
        x2 = x2.clamp(0, w)
        y1 = y1.clamp(0, h)
        y2 = y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox_overlaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def sort_desc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending sort along the last axis that keeps the lower index first
    among equal values, as ``jax.lax.top_k`` does (``torch.topk`` does not
    promise an order for ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float, max_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed output size.

    boxes [..., N, 4], scores [..., N] (entries <= 0 are absent).  Returns
    (indices [..., max_out] int64, -1 where empty; valid [..., max_out]
    bool): the kept boxes in descending score order."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    order = sort_desc(scores)[1]
    present = scores.gather(1, order) > 0
    sorted_boxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    # X[b, i, j] = 1 where the earlier present box i would suppress j
    mm_dtype = torch.float16 if boxes.is_cuda else torch.float32
    upper = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu_(1)
    sup = torch.stack([
        (bbox_overlaps(bx, bx) > iou_threshold) & upper
        for bx in sorted_boxes
    ])
    sup = (sup & present[:, :, None]).to(mm_dtype)
    keep = present
    for _ in range(n + 1):
        hit = torch.bmm(keep.to(mm_dtype)[:, None, :], sup)[:, 0] > 0
        new = present & ~hit
        if torch.equal(new, keep):
            break
        keep = new
    # the first max_out kept entries, in order; the rest go to a spare slot
    rank = keep.long().cumsum(1) - 1
    slot = torch.where(keep & (rank < max_out), rank,
                       torch.full_like(rank, max_out))
    idxs = torch.full((keep.shape[0], max_out + 1), -1, dtype=torch.long,
                      device=boxes.device)
    idxs.scatter_(1, slot, torch.where(keep, order, -1))
    idxs = idxs[:, :max_out]
    return idxs.reshape(*lead, max_out), (idxs >= 0).reshape(*lead, max_out)


def soft_nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    method: str = "linear",
    sigma: float = 0.5,
    min_score: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-NMS with a fixed output size (mmdet's soft-NMS for R-CNN
    testing): each pick decays the remaining scores instead of removing
    its overlaps, ``linear`` s *= 1 - iou where iou > ``iou_threshold``,
    ``gaussian`` s *= exp(-iou^2 / sigma) everywhere; picks stop once the
    best remaining score is <= ``min_score``.

    boxes [..., N, 4], scores [..., N] (entries <= 0 are absent).  Returns
    (indices [..., max_out] int64, -1 where empty; decayed scores
    [..., max_out]; valid [..., max_out] bool) in pick order: ``max_out``
    steps of argmax (the first of equal maxima) and decay, as the JAX
    package's loop."""
    if method not in ("linear", "gaussian"):
        raise ValueError(f"unknown soft-nms method: {method}")
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    live = scores.reshape(-1, n)
    live = torch.where(live > 0.0, live, torch.full_like(live, -math.inf))
    iou = bbox_overlaps(boxes, boxes)
    rows = torch.arange(live.shape[0], device=live.device)
    idxs = torch.full((live.shape[0], max_out), -1, dtype=torch.long,
                      device=live.device)
    out_scores = torch.zeros((live.shape[0], max_out), dtype=live.dtype,
                             device=live.device)
    valid = torch.zeros((live.shape[0], max_out), dtype=torch.bool,
                        device=live.device)
    for i in range(max_out):
        best = live.argmax(-1)
        bs = live[rows, best]
        ok = bs > min_score
        idxs[:, i] = torch.where(ok, best, -1)
        out_scores[:, i] = torch.where(ok, bs, 0.0)
        valid[:, i] = ok
        row = iou[rows, best]
        if method == "linear":
            decay = torch.where(row > iou_threshold, 1.0 - row, 1.0)
        else:
            decay = torch.exp(-(row * row) / sigma)
        # decay only finite (not yet picked) entries: -inf * 0 would be
        # NaN on exact duplicates (the linear decay is 0 at iou 1)
        decayed = torch.where(torch.isfinite(live), live * decay, live)
        live = torch.where(ok[:, None], decayed, live)
        live[rows, best] = -math.inf
    return (idxs.reshape(*lead, max_out), out_scores.reshape(*lead, max_out),
            valid.reshape(*lead, max_out))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, M] -> x[b, idx[b]] [B, M, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def multiclass_nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    score_thr: float,
    iou_threshold: float,
    max_per_img: int,
    pre_nms_top_n: int = 1000,
):
    """Class-wise NMS (mmdet ``multiclass_nms``) at fixed shapes.

    boxes [..., N, 4] (class-agnostic) or [..., N, K, 4] (class-specific),
    scores [..., N, K] probabilities.  A (box, class) pair is a candidate
    where its score exceeds ``score_thr``; the ``pre_nms_top_n`` best pairs
    go to NMS, classes never suppress each other (coordinates offset per
    class by the image's largest coordinate + 1).  Returns (det_boxes
    [..., M, 4], det_scores [..., M], det_labels [..., M] int64 (-1 where
    empty), valid [..., M] bool), M = max_per_img, by descending score."""
    lead = scores.shape[:-2]
    n, num_classes = scores.shape[-2:]
    class_specific = boxes.dim() == scores.dim() + 1
    boxes = boxes.reshape(-1, n, num_classes, 4) if class_specific \
        else boxes.reshape(-1, n, 4)
    flat = scores.reshape(-1, n * num_classes)
    flat = torch.where(flat > score_thr, flat, torch.zeros_like(flat))
    k = min(pre_nms_top_n, n * num_classes)
    top_scores, top_idx = (t[:, :k] for t in sort_desc(flat))
    labels = top_idx % num_classes
    rows = top_idx // num_classes
    if class_specific:
        b = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
        top_boxes = boxes[b, rows, labels]
    else:
        top_boxes = gather_rows(boxes, rows)
    span = boxes.reshape(boxes.shape[0], -1).amax(1) + 1.0
    offset = top_boxes + (labels.to(boxes.dtype) * span[:, None])[..., None]
    idxs, valid = nms_fixed(offset, top_scores, iou_threshold, max_per_img)
    safe = idxs.clamp(min=0)
    det_boxes = torch.where(valid[..., None], gather_rows(top_boxes, safe),
                            0.0)
    det_scores = torch.where(valid, gather_rows(top_scores, safe), 0.0)
    det_labels = torch.where(valid, gather_rows(labels, safe), -1)
    m = max_per_img
    return (det_boxes.reshape(*lead, m, 4), det_scores.reshape(*lead, m),
            det_labels.reshape(*lead, m), valid.reshape(*lead, m))
