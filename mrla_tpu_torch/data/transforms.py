"""Image transforms: host-side geometry and draws (numpy), device-side math
(PyTorch).

  * train: RandomResizedCrop + HFlip + normalize (scale (0.08, 1.0), ratio
    (3/4, 4/3), torchvision's ``get_params``);
  * eval: resize the shorter side to crop / crop_pct, center-crop,
    normalize;
  * Mixup / CutMix (timm's defaults mixup 0.8, cutmix 1.0, switch 0.5): one
    mode per batch, λ from Beta(α, α), the pair the reversed batch, soft
    targets with the label smoothing folded in;
  * random erasing (timm's 'pixel' mode: gaussian fill, p = 0.25).

Every draw of Mixup / CutMix and of the erasing boxes is made on the host
from a seeded ``np.random.Generator``, as timm's ``Mixup`` does
(``torch.distributions.Beta`` takes no generator), and applied on the
device; the flips and the erasing noise come from a device
``torch.Generator``.  The port's own copy of the JAX package's
``data/transforms.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 / float [0, 255] NHWC -> normalized float32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.float() / 255.0 - mean) / std


def random_flip(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Each NHWC image mirrored left-right with probability 0.5."""
    flip = torch.rand(x.shape[0], generator=generator, device=x.device) < 0.5
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def random_resized_crop_params(
    rng: np.random.Generator,
    height: int,
    width: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: returns (top, left, h, w)."""
    area = height * width
    log_ratio = np.log(ratio)
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # fallback: center crop at clamped aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def eval_transform_params(
    height: int, width: int, crop: int = 224, crop_pct: float = 224 / 256
) -> Tuple[int, int, int, int, int]:
    """Eval geometry: resize shorter side to crop/crop_pct, center-crop.

    Returns (resize_h, resize_w, top, left, crop)."""
    size = int(round(crop / crop_pct))
    if height <= width:
        rh, rw = size, max(1, int(round(width * size / height)))
    else:
        rh, rw = max(1, int(round(height * size / width))), size
    top = (rh - crop) // 2
    left = (rw - crop) // 2
    return rh, rw, top, left, crop


def center_crop_resize(img: torch.Tensor, out_size: int = 224
                       ) -> torch.Tensor:
    """The eval transform of one decoded [H, W, 3] image: bilinear resize
    (half-pixel centres; a downscale antialiased, as ``jax.image.resize``,
    which the JAX package calls, does by default), center crop, normalize.
    Returns [out_size, out_size, 3] float32."""
    h, w = img.shape[0], img.shape[1]
    rh, rw, top, left, c = eval_transform_params(h, w, out_size)
    x = F.interpolate(img.float().permute(2, 0, 1)[None], size=(rh, rw),
                      mode="bilinear", align_corners=False, antialias=True)
    x = x[0].permute(1, 2, 0)[top:top + c, left:left + c]
    return normalize(x)


class MixDraw(NamedTuple):
    """One batch's Mixup / CutMix draw: the mode, the mixing weight of the
    batch itself, and the CutMix box (y0, y1, x0, x1), empty for Mixup."""

    use_cutmix: bool
    lam: float
    box: Tuple[int, int, int, int]


def draw_mixup_cutmix(rng: np.random.Generator, height: int, width: int,
                      mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                      switch_prob: float = 0.5) -> MixDraw:
    """One batch's draw: CutMix with probability ``switch_prob``, else
    Mixup; λ ~ Beta(α, α); CutMix's box of side sqrt(1 - λ) centred on a
    uniform pixel and clipped to the image, λ then its uncovered share."""
    if rng.random() < switch_prob:
        lam = rng.beta(cutmix_alpha, cutmix_alpha)
        cut = np.sqrt(1.0 - lam)
        ch, cw = int(height * cut), int(width * cut)
        cy, cx = int(rng.integers(0, height)), int(rng.integers(0, width))
        y0, y1 = np.clip([cy - ch // 2, cy + ch // 2], 0, height)
        x0, x1 = np.clip([cx - cw // 2, cx + cw // 2], 0, width)
        lam = 1.0 - (y1 - y0) * (x1 - x0) / (height * width)
        return MixDraw(True, float(lam), (int(y0), int(y1), int(x0), int(x1)))
    return MixDraw(False, float(rng.beta(mixup_alpha, mixup_alpha)),
                   (0, 0, 0, 0))


def apply_mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, draw: MixDraw,
                       label_smoothing: float = 0.1):
    """(images mixed with the reversed batch, soft targets [B, K]) for one
    ``draw``, on the images' device."""
    x = images.float()
    flipped = x.flip(0)
    if draw.use_cutmix:
        y0, y1, x0, x1 = draw.box
        out = x.clone()
        out[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
    else:
        out = draw.lam * x + (1.0 - draw.lam) * flipped
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    t1 = F.one_hot(labels.long(), num_classes).float() * (on - off) + off
    targets = draw.lam * t1 + (1.0 - draw.lam) * t1.flip(0)
    return out.to(images.dtype), targets


def mixup_cutmix(rng: np.random.Generator, images: torch.Tensor,
                 labels: torch.Tensor, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, label_smoothing: float = 0.1):
    """Batch-level Mixup / CutMix with soft targets: the draw on the host
    from ``rng``, applied on the device."""
    draw = draw_mixup_cutmix(rng, images.shape[1], images.shape[2],
                             mixup_alpha, cutmix_alpha, switch_prob)
    return apply_mixup_cutmix(images, labels, num_classes, draw,
                              label_smoothing)


def draw_erasing(rng: np.random.Generator, batch: int, height: int,
                 width: int, prob: float = 0.25, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3
                 ) -> np.ndarray:
    """Per-sample erasing boxes [B, 4] (top, left, h, w) int64; h = 0 where
    the sample is not erased."""
    boxes = np.zeros((batch, 4), np.int64)
    for i in range(batch):
        do = rng.random() < prob
        area = height * width * rng.uniform(min_area, max_area)
        ar = np.exp(rng.uniform(np.log(min_aspect), -np.log(min_aspect)))
        eh = int(np.clip(int(np.sqrt(area * ar)), 1, height - 1))
        ew = int(np.clip(int(np.sqrt(area / ar)), 1, width - 1))
        top = int(rng.integers(0, height - eh))
        left = int(rng.integers(0, width - ew))
        if do:
            boxes[i] = (top, left, eh, ew)
    return boxes


def random_erasing(rng: np.random.Generator, images: torch.Tensor,
                   generator: torch.Generator, prob: float = 0.25,
                   **box_kw) -> torch.Tensor:
    """Per-sample random erasing with gaussian fill (timm 'pixel' mode):
    boxes drawn on the host from ``rng``, the noise on the device from
    ``generator``."""
    b, h, w, _ = images.shape
    boxes = torch.from_numpy(draw_erasing(rng, b, h, w, prob, **box_kw)).to(
        images.device)
    top, left, eh, ew = boxes.unbind(1)
    yy = torch.arange(h, device=images.device)[None, :]
    xx = torch.arange(w, device=images.device)[None, :]
    inside = (((yy >= top[:, None]) & (yy < (top + eh)[:, None]))[:, :, None]
              & ((xx >= left[:, None]) & (xx < (left + ew)[:, None]))[
                  :, None, :])
    noise = torch.randn(images.shape, generator=generator,
                        device=images.device)
    return torch.where(inside[..., None], noise,
                       images.float()).to(images.dtype)
