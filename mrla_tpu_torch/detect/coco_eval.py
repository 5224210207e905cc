"""COCO-style detection mAP (host-side numpy evaluator).

The port's own copy of the JAX package's ``detect/coco_eval.py`` (numpy
only, nothing imported from there), for the trainer's ``evaluate``.

The reference evaluates detection through upstream MMDetection, which
delegates to pycocotools' COCOeval (not available in this environment;
the reference workflow prints its 12-stat table per README.md:88-92).
This re-implements the COCOeval bbox/segm protocol so users can score
detections natively, matching pycocotools' documented semantics:

  * detections processed in descending score order, at most ``max_dets``
    per image (AR reported at 1/10/100, AP at the largest);
  * a detection matches the not-yet-matched ground truth of ITS class
    with the highest IoU ≥ the threshold (greedy, per COCOeval's
    ``evaluateImg``); crowd ground truths (``iscrowd``) are IGNORE
    regions — they can absorb any number of detections, their IoU uses
    the detection's area as the denominator, and detections matched to
    them count neither as TP nor FP;
  * area-range breakdowns (small <32², medium 32²-96², large >96²):
    out-of-range ground truths become ignore regions for that range, and
    unmatched out-of-range detections are dropped from the FP count;
  * AP per (class, IoU threshold, range) via 101-point interpolation
    (recall grid 0:.01:1, precision made monotone from the right);
    recall (AR) is the final recall value;
  * means are over classes with ≥1 non-ignored ground truth and over the
    ten thresholds 0.50:0.05:0.95; AP50/AP75 are the usual slices.

Inputs are plain arrays, so the evaluator has no COCO-json dependency;
ground-truth mappings may carry ``iscrowd`` [N] and ``areas`` [N]
(COCO's annotation ``area`` is the segmentation area — pass it for
json-exact range bucketing; the fallback is box area for bbox / pixel
count for segm, which is what array-only pipelines have).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)  # COCOeval's exact grid
RECALL_GRID = np.linspace(0.0, 1.0, 101)


def paste_masks(
    masks: np.ndarray,
    boxes: np.ndarray,
    img_hw,
    threshold: float = 0.5,
) -> np.ndarray:
    """Paste per-detection soft masks into image coordinates (host-side
    numpy — mmdet performs this step on CPU as well).

    masks [M, S, S] sigmoid outputs from the mask head, boxes [M, 4]
    xyxy -> [M, H, W] binary masks.  Bilinear resize of each S×S grid
    onto its box (mmcv ``_do_paste_mask`` semantics: mask cell centers
    span the box), thresholded at ``mask_thr_binary=0.5``
    (mask_rcnn_r50mrlal_fpn.py:121).
    """
    h, w = img_hw
    m, s, _ = masks.shape
    out = np.zeros((m, h, w), bool)
    for i in range(m):
        x1, y1, x2, y2 = boxes[i]
        bw, bh = x2 - x1, y2 - y1
        if bw <= 0 or bh <= 0:
            continue
        xs = np.arange(int(np.floor(x1)), int(np.ceil(x2)))
        ys = np.arange(int(np.floor(y1)), int(np.ceil(y2)))
        xs = xs[(xs >= 0) & (xs < w)]
        ys = ys[(ys >= 0) & (ys < h)]
        if not len(xs) or not len(ys):
            continue
        # pixel centers -> mask grid coords (cell centers at (k+.5)/S)
        gx = (xs + 0.5 - x1) / bw * s - 0.5
        gy = (ys + 0.5 - y1) / bh * s - 0.5
        gx0 = np.clip(np.floor(gx).astype(int), 0, s - 1)
        gy0 = np.clip(np.floor(gy).astype(int), 0, s - 1)
        gx1 = np.minimum(gx0 + 1, s - 1)
        gy1 = np.minimum(gy0 + 1, s - 1)
        fx = np.clip(gx - gx0, 0, 1)
        fy = np.clip(gy - gy0, 0, 1)
        mk = masks[i]
        top = mk[gy0[:, None], gx0[None, :]] * (1 - fx)[None, :] + mk[
            gy0[:, None], gx1[None, :]
        ] * fx[None, :]
        bot = mk[gy1[:, None], gx0[None, :]] * (1 - fx)[None, :] + mk[
            gy1[:, None], gx1[None, :]
        ] * fx[None, :]
        val = top * (1 - fy)[:, None] + bot * fy[:, None]
        out[i, ys[0] : ys[-1] + 1, xs[0] : xs[-1] + 1] = val >= threshold
    return out


def _iou(
    a: np.ndarray, b: np.ndarray, crowd: Optional[np.ndarray] = None
) -> np.ndarray:
    """Box IoU of detections ``a`` [N, 4] vs ground truths ``b`` [M, 4].

    Where ``crowd`` [M] is set, the denominator is the DETECTION's area
    (pycocotools ``maskUtils.iou`` iscrowd semantics: a crowd region is
    an ignore region — a detection lying inside it overlaps "fully"
    regardless of the crowd's extent).
    """
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = aa[:, None] + ab[None, :] - inter
    if crowd is not None and crowd.any():
        union = np.where(crowd[None, :], aa[:, None], union)
    return inter / np.maximum(union, 1e-10)


def _interp_ap(scores: np.ndarray, matched: np.ndarray, num_gt: int) -> float:
    """101-point interpolated AP from per-detection (score, hit) pairs."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="mergesort")
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
    # monotone envelope from the right (COCOeval)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    # precision at the first recall index reaching each grid point
    idx = np.searchsorted(recall, RECALL_GRID, side="left")
    p = np.zeros_like(RECALL_GRID)
    ok = idx < len(precision)
    p[ok] = precision[idx[ok]]
    return float(p.mean())


def _mask_iou(
    a: np.ndarray, b: np.ndarray, crowd: Optional[np.ndarray] = None
) -> np.ndarray:
    """Pixel IoU between boolean mask sets: a [N, H, W] dets,
    b [M, H, W] gts; ``crowd`` columns use the det-area denominator."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    af = a.reshape(len(a), -1).astype(np.float64)
    bf = b.reshape(len(b), -1).astype(np.float64)
    inter = af @ bf.T
    area_a = af.sum(1)
    area_b = bf.sum(1)
    union = area_a[:, None] + area_b[None, :] - inter
    if crowd is not None and crowd.any():
        union = np.where(crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-10)


# COCOeval's area-range grid (areaRng / areaRngLbl)
AREA_RANGES: Dict[str, tuple] = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _match_image(
    iou: np.ndarray,
    gt_ignore: np.ndarray,
    crowd: np.ndarray,
    iou_thrs: np.ndarray,
):
    """COCOeval ``evaluateImg`` matching core for one (image, class,
    area range): ``iou`` [D, G] with detections score-sorted and ground
    truths sorted ignore-LAST; ``gt_ignore``/``crowd`` [G] in that same
    order.  Returns (dt_matched [T, D], dt_ignore [T, D]) where a
    detection matched to an ignored gt is flagged ignored.

    Semantics preserved from pycocotools: a det takes the BEST-IoU
    available gt ≥ the threshold; an already-matched gt is unavailable
    unless it is a crowd; once a det holds a regular-gt match it stops
    considering ignored gts (the ordering makes that a ``break``)."""
    T, (D, G) = len(iou_thrs), iou.shape
    dtm = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    gtm = np.zeros((T, G), bool)
    for ti, thr in enumerate(iou_thrs):
        for d in range(D):
            best = min(thr, 1.0 - 1e-10)
            m = -1
            for g in range(G):
                if gtm[ti, g] and not crowd[g]:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if iou[d, g] < best:
                    continue
                best = iou[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[ti, d] = gt_ignore[m]
            dtm[ti, d] = True
            gtm[ti, m] = True
    return dtm, dt_ig


def evaluate_detections(
    predictions: Sequence[Mapping[str, np.ndarray]],
    ground_truths: Sequence[Mapping[str, np.ndarray]],
    num_classes: int,
    iou_thrs: Optional[np.ndarray] = None,
    max_dets: Sequence[int] = (1, 10, 100),
    iou_kind: str = "bbox",
    area_ranges: Optional[Mapping[str, tuple]] = None,
) -> Dict[str, float]:
    """predictions / ground_truths: one mapping per image with keys
    ``boxes`` [N, 4] xyxy, ``labels`` [N] int, and (predictions only)
    ``scores`` [N].  Ground truths may also carry ``iscrowd`` [N]
    (crowd = ignore region, COCOeval semantics) and ``areas`` [N] (the
    COCO annotation ``area``; defaults to box area / mask pixel count).
    Rows may include padding — pass only valid rows or filter with a
    ``valid`` mask beforehand.

    ``iou_kind="segm"`` scores instance segmentation instead (COCOeval
    segm protocol): both sides must then also carry ``masks`` [N, H, W]
    boolean arrays (predictions pasted to image resolution, e.g. via
    :func:`paste_masks`), and matching uses pixel IoU; scores/labels
    still come from the detection head.

    Returns the COCOeval 12-stat schema (the table the reference's mmdet
    workflow prints, README.md:88-92) plus per-threshold slices::

        mAP  AP50  AP75  mAP_s  mAP_m  mAP_l
        AR@1  AR@10  AR@100  AR_s  AR_m  AR_l
        AP@<thr> ...  per_class {cls: AP}

    Empty cells follow COCOeval: −1 when a range/class has no ground
    truth (except the legacy ``mAP``/``AP50``/``AP75`` keys, which stay
    0.0 for an empty dataset, as earlier revisions returned).
    """
    if iou_thrs is None:
        iou_thrs = IOU_THRS
    if isinstance(max_dets, (int, np.integer)):
        max_dets = (int(max_dets),)
    max_dets = sorted(int(m) for m in max_dets)
    md_max = max_dets[-1]
    if area_ranges is None:
        area_ranges = AREA_RANGES
    rnames = list(area_ranges)
    bounds = [area_ranges[r] for r in rnames]
    assert len(predictions) == len(ground_truths)
    assert iou_kind in ("bbox", "segm")
    T, R, M = len(iou_thrs), len(rnames), len(max_dets)

    ap = np.full((num_classes, T, R), np.nan)
    rec = np.full((num_classes, T, R, M), np.nan)
    for cls in range(num_classes):
        # per range: per-image (scores, dtm [T, D], dt_ig [T, D]) + npig
        imgs: List[List[tuple]] = [[] for _ in rnames]
        npig = np.zeros(R, np.int64)
        for pred, gt in zip(predictions, ground_truths):
            g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
            g_lab = np.asarray(gt["labels"]).reshape(-1)
            g_sel = g_lab == cls
            g_boxes = g_boxes[g_sel]
            g_crowd = (
                np.asarray(gt["iscrowd"]).reshape(-1)[g_sel].astype(bool)
                if "iscrowd" in gt
                else np.zeros(len(g_boxes), bool)
            )
            p_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            p_lab = np.asarray(pred["labels"]).reshape(-1)
            p_scores = np.asarray(pred["scores"], np.float64).reshape(-1)
            sel = p_lab == cls
            p_boxes, p_scores = p_boxes[sel], p_scores[sel]
            order = np.argsort(-p_scores, kind="mergesort")[:md_max]
            p_boxes, p_scores = p_boxes[order], p_scores[order]
            if iou_kind == "segm":
                g_masks = np.asarray(gt["masks"], bool)[g_sel]
                p_masks = np.asarray(pred["masks"], bool)[sel][order]
                iou = _mask_iou(p_masks, g_masks, g_crowd)
                # numpy rejects reshape(0, -1); empty sets sum to [0]-areas
                d_area = (p_masks.reshape(len(p_masks), -1).sum(1)
                          if len(p_masks) else np.zeros(0, np.int64))
                g_area_dflt = (g_masks.reshape(len(g_masks), -1).sum(1)
                               if len(g_masks) else np.zeros(0, np.int64))
            else:
                iou = _iou(p_boxes, g_boxes, g_crowd)
                d_area = (p_boxes[:, 2] - p_boxes[:, 0]) * (
                    p_boxes[:, 3] - p_boxes[:, 1]
                )
                g_area_dflt = (g_boxes[:, 2] - g_boxes[:, 0]) * (
                    g_boxes[:, 3] - g_boxes[:, 1]
                )
            g_area = (
                np.asarray(gt["areas"], np.float64).reshape(-1)[g_sel]
                if "areas" in gt
                else g_area_dflt
            )
            for ri, (lo, hi) in enumerate(bounds):
                g_ig = g_crowd | (g_area < lo) | (g_area > hi)
                gord = np.argsort(g_ig, kind="mergesort")  # ignore-last
                dtm, dt_ig = _match_image(
                    iou[:, gord], g_ig[gord], g_crowd[gord], iou_thrs
                )
                # unmatched out-of-range detections are dropped too
                d_out = (d_area < lo) | (d_area > hi)
                dt_ig |= ~dtm & d_out[None, :]
                imgs[ri].append((p_scores, dtm, dt_ig))
                npig[ri] += int((~g_ig).sum())

        for ri in range(R):
            if npig[ri] == 0:
                continue  # stays NaN -> excluded from means (COCOeval -1)
            for mi, md in enumerate(max_dets):
                scores = np.concatenate([s[:md] for s, _, _ in imgs[ri]])
                for ti in range(T):
                    dtm = np.concatenate(
                        [m[ti, :md] for _, m, _ in imgs[ri]]
                    )
                    ig = np.concatenate(
                        [g[ti, :md] for _, _, g in imgs[ri]]
                    )
                    keep = ~ig
                    rec[cls, ti, ri, mi] = (
                        dtm[keep].sum() / npig[ri] if npig[ri] else np.nan
                    )
                    if mi == M - 1:
                        ap[cls, ti, ri] = _interp_ap(
                            scores[keep], dtm[keep], int(npig[ri])
                        )

    def _mean(a) -> float:
        return float(np.nanmean(a)) if not np.isnan(a).all() else -1.0

    ri_all = rnames.index("all") if "all" in rnames else 0
    present = ~np.isnan(ap[:, 0, ri_all])
    res: Dict[str, float] = {}
    res["mAP"] = (
        float(np.nanmean(ap[present, :, ri_all])) if present.any() else 0.0
    )
    for ti, thr in enumerate(iou_thrs):
        res[f"AP@{thr:.2f}"] = (
            float(np.nanmean(ap[present, ti, ri_all]))
            if present.any()
            else 0.0
        )
    res["AP50"] = res.get("AP@0.50", 0.0)
    res["AP75"] = res.get("AP@0.75", 0.0)
    for rname, suffix in (("small", "s"), ("medium", "m"), ("large", "l")):
        if rname in rnames:
            ri = rnames.index(rname)
            res[f"mAP_{suffix}"] = _mean(ap[:, :, ri])
            res[f"AR_{suffix}"] = _mean(rec[:, :, ri, M - 1])
    for mi, md in enumerate(max_dets):
        res[f"AR@{md}"] = _mean(rec[:, :, ri_all, mi])
    res["per_class"] = {
        int(c): float(np.nanmean(ap[c, :, ri_all]))
        for c in range(num_classes)
        if present[c]
    }
    return res
