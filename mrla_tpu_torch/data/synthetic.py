"""Synthetic data (numpy only), the port's own copy of the JAX package's
``data/synthetic.py``; the same seed gives the same arrays, bit for bit, in
both packages.  Images are square, ``image_size`` on a side.

  * ``synthetic_batches``: the classification source of ``train/cli.py``:
    noise images with random labels (``--data synthetic``: shapes and
    throughput, nothing to learn), or, with ``learnable``, a fixed random
    template per class plus per-sample noise (``--data
    synthetic-learnable``: a working trainer drives the loss well below
    ln(num_classes)).
  * ``synthetic_detection_batches``: the learnable squares task the
    detection trainer trains on with ``--data synthetic-detect``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterator

import numpy as np


@lru_cache(maxsize=4)
def _templates(num_classes: int, image_size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((num_classes, image_size, image_size, 3)) * 0.5
    ).astype(np.float32)


def synthetic_batches(
    batch_size: int,
    image_size: int = 224,
    num_classes: int = 1000,
    steps: int = 10,
    seed: int = 0,
    learnable: bool = False,
    noise: float = 0.5,
    template_seed: int = 0,
) -> Iterator[dict]:
    """``steps`` batches {"image": [B, S, S, 3] float32, "label": [B]
    int32}."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        labels = rng.integers(0, num_classes, batch_size).astype(np.int32)
        if learnable:
            t = _templates(num_classes, image_size, template_seed)
            images = t[labels] + rng.standard_normal(
                (batch_size, image_size, image_size, 3)
            ).astype(np.float32) * noise
        else:
            images = rng.standard_normal(
                (batch_size, image_size, image_size, 3)
            ).astype(np.float32)
        yield {"image": images, "label": labels}


def synthetic_detection_batches(
    batch_size: int,
    image_size: int = 256,
    num_classes: int = 4,
    steps: int = 10,
    max_gt: int = 8,
    seed: int = 0,
    with_masks: bool = False,
) -> Iterator[dict]:
    """Learnable detection task: 1-3 axis-aligned bright squares per image
    on a noisy background; the class IS the square's color channel pattern
    (class c lights channel c%3 with intensity keyed to c//3).  A working
    detector must localize and classify them; detection smokes and the
    detect CLI's `--data synthetic-detect` use this.

    Yields image [B,H,W,3], gt_boxes [B,max_gt,4] xyxy, gt_labels,
    gt_valid (+ gt_masks [B,max_gt,H,W] when ``with_masks``).
    """
    rng = np.random.default_rng(seed)
    s = image_size
    for _ in range(steps):
        images = rng.standard_normal((batch_size, s, s, 3)).astype(
            np.float32
        ) * 0.1
        gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
        gt_labels = np.zeros((batch_size, max_gt), np.int32)
        gt_valid = np.zeros((batch_size, max_gt), bool)
        gt_masks = (
            np.zeros((batch_size, max_gt, s, s), np.float32)
            if with_masks
            else None
        )
        for b in range(batch_size):
            n = int(rng.integers(1, min(4, max_gt + 1)))
            for g in range(n):
                side = int(rng.integers(s // 8, s // 3))
                x0 = int(rng.integers(0, s - side))
                y0 = int(rng.integers(0, s - side))
                cls = int(rng.integers(0, num_classes))
                val = 1.0 + 0.75 * (cls // 3)
                images[b, y0 : y0 + side, x0 : x0 + side, cls % 3] = val
                gt_boxes[b, g] = [x0, y0, x0 + side, y0 + side]
                gt_labels[b, g] = cls
                gt_valid[b, g] = True
                if with_masks:
                    gt_masks[b, g, y0 : y0 + side, x0 : x0 + side] = 1.0
        out = {
            "image": images,
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
            "sample_valid": np.ones((batch_size,), bool),
        }
        if with_masks:
            out["gt_masks"] = gt_masks
        yield out
