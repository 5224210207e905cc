"""COCO-format detection data (stdlib json, no pycocotools): the port's
own copy of the JAX package's ``data/coco.py`` (numpy and PIL; nothing is
imported from there), so that both packages read the same batches, bit for
bit, from the same files and seed.

The reference trains detection through MMDetection's CocoDataset with the
coco_detection.py pipeline: keep-ratio resize to (1333, 800), random
horizontal flip p = 0.5, normalisation with the torchvision mean / std,
padding to a stride-32 canvas.  At fixed shapes here:

  * every image is keep-ratio resized (PIL bilinear) to fit the static
    canvas (default 800 x 1344, both divisible by 32) and zero-padded
    bottom / right; boxes scale with the image;
  * gt boxes / labels are padded to ``max_gt`` with a validity mask;
  * labels are contiguous [0, num_classes) in sorted category-id order
    (COCO ids are sparse; mmdet's ``cat2label``);
  * annotations with ``iscrowd=1`` or a zero width / height are dropped
    from training; crowd regions come back for evaluation
    (``load_eval_extras``).

Masks decode without pycocotools: polygons by even-odd rasterisation
(``polygons_to_mask``), RLE compressed or not (``rle_to_mask``, the 6-bit
string format of maskApi.c), letterboxed and flipped with the image.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# torchvision-convention normalization, as in the reference pipelines
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def polygons_to_mask(polys, h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation -> [h, w] bool mask.

    Even-odd ray casting at pixel CENTERS; an annotation's multiple
    polygons union (pycocotools merge semantics).  Not bit-identical to
    pycocotools' integer edge rasterizer at boundary pixels — interior
    agreement is exact, and the ±half-pixel boundary band is far below
    the 28×28 mask-target resolution this feeds.
    """
    ys, xs = np.mgrid[0:h, 0:w]
    px = xs + 0.5
    py = ys + 0.5
    mask = np.zeros((h, w), bool)
    for poly in polys:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        inside = np.zeros((h, w), bool)
        xa, ya = p[:, 0], p[:, 1]
        xb, yb = np.roll(xa, -1), np.roll(ya, -1)
        for j in range(len(p)):
            crosses = ((ya[j] <= py) & (yb[j] > py)) | (
                (yb[j] <= py) & (ya[j] > py)
            )
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = xa[j] + (py - ya[j]) * (xb[j] - xa[j]) / (
                    yb[j] - ya[j]
                )
            inside ^= crosses & (px < xint)
        mask |= inside
    return mask


def _rle_counts_from_string(s: str) -> list:
    """pycocotools compressed-RLE string -> run counts (maskApi.c
    rleFrString: 6-bit groups, 0x20 continuation, 0x10 sign extension,
    counts[i>2] are deltas from counts[i-2])."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: dict) -> np.ndarray:
    """COCO RLE segmentation (compressed str or uncompressed list
    counts) -> [h, w] bool mask.  Runs alternate 0/1 in COLUMN-major
    order (pycocotools layout)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        if isinstance(counts, bytes):
            counts = counts.decode()
        counts = _rle_counts_from_string(counts)
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Either COCO segmentation form -> [h, w] bool mask."""
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    return polygons_to_mask(seg, h, w)


class CocoDetection:
    """Index over a COCO instances json + image directory."""

    def __init__(self, ann_file: str, img_dir: str,
                 filter_empty: bool = True):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.cat2label = {cid: i for i, cid in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        anns_by_img: Dict[int, List[dict]] = {}
        crowd_by_img: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            x, y, w, h = a["bbox"]  # COCO xywh
            if w <= 0 or h <= 0:
                continue
            if a.get("iscrowd", 0):
                # kept for EVAL (COCOeval ignore regions); excluded from
                # training targets (mmdet routes them to
                # gt_bboxes_ignore — a training-assigner refinement our
                # MaxIoU assigner does not consume, documented gap)
                crowd_by_img.setdefault(a["image_id"], []).append(a)
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.items: List[Tuple[dict, List[dict], List[dict]]] = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if filter_empty and not anns:
                continue
            self.items.append(
                (img, anns, crowd_by_img.get(img["id"], []))
            )

    def __len__(self) -> int:
        return len(self.items)

    def load_eval_extras(self, i: int) -> Dict[str, np.ndarray]:
        """Per-image COCOeval inputs in ORIGINAL image coordinates:
        ``areas`` [N] (the json annotation ``area`` — the segmentation
        area — falling back to box area), plus the crowd ignore regions
        ``crowd_boxes`` [Nc, 4] xyxy / ``crowd_labels`` [Nc] /
        ``crowd_areas`` [Nc]."""
        _, anns, crowd = self.items[i]

        def area(a):
            x, y, w, h = a["bbox"]
            return float(a.get("area", w * h))

        cboxes = [
            [a["bbox"][0], a["bbox"][1],
             a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
            for a in crowd
        ]
        return {
            "areas": np.asarray([area(a) for a in anns], np.float32),
            "crowd_boxes": np.asarray(cboxes, np.float32).reshape(-1, 4),
            "crowd_labels": np.asarray(
                [self.cat2label[a["category_id"]] for a in crowd],
                np.int32,
            ),
            "crowd_areas": np.asarray(
                [area(a) for a in crowd], np.float32
            ),
        }

    def load(self, i: int, with_masks: bool = False):
        """-> (image uint8 [H, W, 3], boxes [N, 4] xyxy, labels [N]
        [, masks [N, H, W] bool]).  Annotations without a segmentation
        fall back to a box-filled mask (documented pragmatic default —
        mmdet would error instead)."""
        from PIL import Image

        info, anns, _ = self.items[i]
        img = Image.open(
            os.path.join(self.img_dir, info["file_name"])
        ).convert("RGB")
        arr = np.asarray(img, np.uint8)
        ih, iw = arr.shape[:2]
        boxes, labels, masks = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat2label[a["category_id"]])
            if with_masks:
                seg = a.get("segmentation")
                if seg:
                    masks.append(segmentation_to_mask(seg, ih, iw))
                else:
                    m = np.zeros((ih, iw), bool)
                    m[int(y):int(np.ceil(y + h)),
                      int(x):int(np.ceil(x + w))] = True
                    masks.append(m)
        out = (
            arr,
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
        )
        if with_masks:
            stacked = (
                np.stack(masks) if masks else np.zeros((0, ih, iw), bool)
            )
            return out + (stacked,)
        return out


def letterbox(
    img: np.ndarray,
    boxes: np.ndarray,
    canvas_hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Keep-ratio resize into the top-left of a fixed canvas (mmdet
    Resize(keep_ratio=True) + Pad(size_divisor=32), which also pads
    bottom/right).  Returns (float32 canvas NOT normalized, boxes,
    (resized_h, resized_w) — the content region, needed so flips mirror
    the IMAGE, not the padding)."""
    from PIL import Image

    ch, cw = canvas_hw
    h, w = img.shape[:2]
    scale = min(ch / h, cw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.float32
    )
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:nh, :nw] = resized
    return canvas, boxes * scale, (nh, nw)


def hflip(
    img: np.ndarray, boxes: np.ndarray, content_w: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip of the CONTENT region (mmdet flips before padding,
    so the pad stays on the right)."""
    w = content_w if content_w is not None else img.shape[1]
    out = boxes.copy()
    if len(boxes):
        out[:, 0] = w - boxes[:, 2]
        out[:, 2] = w - boxes[:, 0]
    img = img.copy()
    img[:, :w] = img[:, :w][:, ::-1]
    return img, out


def _letterbox_mask(
    mask: np.ndarray, canvas_hw: Tuple[int, int], nh: int, nw: int
) -> np.ndarray:
    """Nearest-resize one [H, W] bool mask into the (nh, nw) content
    region of the fixed canvas (same geometry as the image letterbox)."""
    from PIL import Image

    out = np.zeros(canvas_hw, bool)
    out[:nh, :nw] = np.asarray(
        Image.fromarray(mask.astype(np.uint8) * 255).resize(
            (nw, nh), Image.NEAREST
        )
    ) > 127
    return out


def coco_batches(
    ds: CocoDetection,
    batch_size: int,
    canvas_hw: Tuple[int, int] = (800, 1344),
    max_gt: int = 100,
    shuffle: bool = True,
    augment: bool = True,
    seed: int = 0,
    indices: Optional[Sequence[int]] = None,
    with_masks: bool = False,
    with_eval_extras: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape batches: images [B, H, W, 3] normalized float32,
    gt_boxes [B, max_gt, 4], gt_labels [B, max_gt], gt_valid [B, max_gt]
    (+ gt_masks [B, max_gt, H, W] bool with ``with_masks``).  The final
    ragged batch pads by repeating row 0 with ``sample_valid`` false
    (mirrors the classification eval contract).

    ``with_eval_extras`` (eval only — crowd regions must NOT reach the
    training assigner) adds the host-side COCOeval inputs: ``scale``
    [B] (letterbox factor, divide canvas boxes by it to get original
    coordinates), ``gt_areas`` [B, max_gt] (json ``area``, original
    scale), and the crowd ignore regions ``crowd_boxes`` [B, Nc, 4]
    (original coords) / ``crowd_labels`` / ``crowd_areas`` /
    ``crowd_valid`` padded to the batch max."""
    rng = np.random.RandomState(seed)
    idx = np.asarray(indices if indices is not None else np.arange(len(ds)))
    if shuffle:
        rng.shuffle(idx)
    for start in range(0, len(idx), batch_size):
        chunk = idx[start : start + batch_size]
        imgs, bxs, lbs, valid, svalid, mks = [], [], [], [], [], []
        extras: List[Dict[str, np.ndarray]] = []
        scales: List[float] = []
        for i in chunk:
            loaded = ds.load(int(i), with_masks=with_masks)
            img, boxes, labels = loaded[:3]
            if with_eval_extras:
                extras.append(ds.load_eval_extras(int(i)))
                scales.append(
                    min(canvas_hw[0] / img.shape[0],
                        canvas_hw[1] / img.shape[1])
                )
            img, boxes, (nh, nw) = letterbox(img, boxes, canvas_hw)
            flip = augment and rng.rand() < 0.5
            if flip:
                img, boxes = hflip(img, boxes, content_w=nw)
            img = (img - MEAN) / STD
            n = min(len(boxes), max_gt)
            pb = np.zeros((max_gt, 4), np.float32)
            pl = np.zeros((max_gt,), np.int32)
            pv = np.zeros((max_gt,), bool)
            pb[:n], pl[:n], pv[:n] = boxes[:n], labels[:n], True
            if with_masks:
                pm = np.zeros((max_gt,) + tuple(canvas_hw), bool)
                for g in range(n):
                    m = _letterbox_mask(loaded[3][g], canvas_hw, nh, nw)
                    if flip:
                        m[:, :nw] = m[:, :nw][:, ::-1]
                    pm[g] = m
                mks.append(pm)
            imgs.append(img)
            bxs.append(pb)
            lbs.append(pl)
            valid.append(pv)
            svalid.append(True)
        while len(imgs) < batch_size:  # ragged tail: repeat row 0
            imgs.append(imgs[0])
            bxs.append(bxs[0])
            lbs.append(lbs[0])
            valid.append(valid[0])
            svalid.append(False)
            if with_masks:
                mks.append(mks[0])
            if with_eval_extras:
                extras.append(extras[0])
                scales.append(scales[0])
        batch = {
            "image": np.stack(imgs),
            "gt_boxes": np.stack(bxs),
            "gt_labels": np.stack(lbs),
            "gt_valid": np.stack(valid),
            "sample_valid": np.asarray(svalid),
        }
        if with_masks:
            batch["gt_masks"] = np.stack(mks)
        if with_eval_extras:
            areas = np.zeros((batch_size, max_gt), np.float32)
            for bi, e in enumerate(extras):
                n = min(len(e["areas"]), max_gt)
                areas[bi, :n] = e["areas"][:n]
            ncrowd = max((len(e["crowd_areas"]) for e in extras),
                         default=0)
            cb = np.zeros((batch_size, ncrowd, 4), np.float32)
            cl = np.zeros((batch_size, ncrowd), np.int32)
            ca = np.zeros((batch_size, ncrowd), np.float32)
            cv = np.zeros((batch_size, ncrowd), bool)
            for bi, e in enumerate(extras):
                n = len(e["crowd_areas"])
                cb[bi, :n] = e["crowd_boxes"]
                cl[bi, :n] = e["crowd_labels"]
                ca[bi, :n] = e["crowd_areas"]
                cv[bi, :n] = True
            batch.update(
                scale=np.asarray(scales, np.float32),
                gt_areas=areas,
                crowd_boxes=cb, crowd_labels=cl,
                crowd_areas=ca, crowd_valid=cv,
            )
        yield batch
