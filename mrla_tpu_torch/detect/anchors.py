"""Anchor generation with MMDetection ``AnchorGenerator`` semantics (the
port's own copy of the JAX package's ``detect/anchors.py``).

Per level, with ``base_size = stride``:

  * ``scales = octave_base_scale * 2**(i / scales_per_octave)``,
  * ``h_ratios = sqrt(ratios)``, ``w_ratios = 1 / h_ratios``,
  * widths ``stride * w_ratios[:, None] * scales[None, :]`` flattened
    ratio-major / scale-minor (the head's A output channels follow it),
  * base anchors centred at the origin: ``[-ws/2, -hs/2, ws/2, hs/2]``,
  * grid anchors shifted by ``(x * stride, y * stride)`` for every cell,
    flattened (H, W, A): y outer, x inner, anchor minor -- the order of an
    NHWC ``[B, H, W, A * K]`` map reshaped to ``[B, H * W * A, K]``.

Anchors depend only on shapes: plain numpy, made once per image size
(``device_anchors`` keeps them on their device).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def base_anchors(
    stride: int,
    octave_base_scale: float = 4.0,
    scales_per_octave: int = 3,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """[A, 4] base anchors (x1, y1, x2, y2) centred at the origin."""
    scales = octave_base_scale * 2.0 ** (
        np.arange(scales_per_octave) / scales_per_octave
    )
    h_ratios = np.sqrt(np.asarray(ratios, np.float64))
    w_ratios = 1.0 / h_ratios
    ws = (stride * w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (stride * h_ratios[:, None] * scales[None, :]).reshape(-1)
    out = np.stack([-ws / 2, -hs / 2, ws / 2, hs / 2], axis=1)
    return out.astype(np.float32)


def grid_anchors(
    featmap_size: Tuple[int, int],
    stride: int,
    base: np.ndarray,
) -> np.ndarray:
    """[H * W * A, 4] anchors for one level, in (H, W, A) order."""
    h, w = featmap_size
    shift_x = np.arange(w, dtype=np.float32) * stride
    shift_y = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # [H, W], y outer
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 4)
    all_anchors = shifts[:, None, :] + base[None, :, :]  # [H*W, A, 4]
    return all_anchors.reshape(-1, 4).astype(np.float32)


def pyramid_anchors(
    featmap_sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    octave_base_scale: float = 4.0,
    scales_per_octave: int = 3,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> list:
    """Per-level [H_i * W_i * A, 4] anchor arrays for an FPN pyramid."""
    if len(featmap_sizes) != len(strides):
        raise ValueError(
            f"{len(featmap_sizes)} feature levels vs {len(strides)} strides"
        )
    return [
        grid_anchors(
            fs, s, base_anchors(s, octave_base_scale, scales_per_octave,
                                ratios),
        )
        for fs, s in zip(featmap_sizes, strides)
    ]


def num_base_anchors(
    scales_per_octave: int = 3, ratios: Sequence[float] = (0.5, 1.0, 2.0)
) -> int:
    """Anchors a cell: one per (ratio, scale)."""
    return scales_per_octave * len(ratios)


@functools.lru_cache(maxsize=8)
def device_anchors(featmap_sizes: tuple, strides: tuple, scale: float,
                   scales_per_octave: int, ratios: tuple, device: str) -> list:
    """:func:`pyramid_anchors` as tensors on ``device``, made once per
    image size (the arguments are the cache's key, hence tuples)."""
    return [torch.from_numpy(a).to(device) for a in pyramid_anchors(
        featmap_sizes, strides, octave_base_scale=scale,
        scales_per_octave=scales_per_octave, ratios=ratios)]


def level_anchors(level_outputs, strides: Sequence[int],
                  octave_base_scale: float = 4.0, scales_per_octave: int = 3,
                  ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> list:
    """The anchors [H * W * A, 4] of each level of ``level_outputs`` (per
    level (cls [B, H, W, ...], reg)), on their device."""
    sizes = tuple(tuple(c.shape[1:3]) for c, _ in level_outputs)
    return device_anchors(sizes, tuple(strides[: len(sizes)]),
                          float(octave_base_scale), scales_per_octave,
                          tuple(ratios), str(level_outputs[0][0].device))
