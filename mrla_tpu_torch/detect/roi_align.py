"""Multi-level RoIAlign (MMDetection ``SingleRoIExtractor`` semantics):
the level mapping, the per-roi geometry that the kernel and its plain
version share, and the plain version.

The reference's two-stage configs extract RoI features with
``RoIAlign(output_size=7, sampling_ratio=0)`` on strides [4, 8, 16, 32]
(faster_rcnn_r50mrlal_fpn.py:38-43).  As in the JAX package's
``detect/roi_align.py``:

  * level: ``clamp(floor(log2(sqrt(w * h) / 56 + 1e-6)), 0, L - 1)``;
  * aligned coordinates: roi / stride - 0.5;
  * each bin averages a gy x gx grid of bilinear samples; a sample outside
    [-1, n] adds zero, one inside is clamped to [0, n - 1];
  * ``sampling_ratio=0`` is mmcv's adaptive grid, ``ceil(bin size)``
    samples per bin and axis, capped at ``max_grid`` slots
    (:func:`default_max_grid`, exact for every roi the FPN mapping makes on
    a COCO canvas); ``sampling_ratio=k > 0`` is the static k x k grid;
  * rows of invalid rois are zero.

:func:`roi_geometry` computes, once per call and on [B, P]-sized tensors,
everything that decides where a roi samples: level, aligned corner, bin
sizes, samples per axis, validity.  The CUDA kernels
(``kernels/roialign_patch.py``), :func:`roi_align_reference` and its
transpose :func:`roi_align_backward_reference` all read that one array, so
they cannot disagree on a level or a sample count.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# columns of the geometry array, one row per roi (fp32; the small integers
# gy, gx, valid and level are exact)
GEOM_Y1, GEOM_X1, GEOM_BIN_Y, GEOM_BIN_X, GEOM_GY, GEOM_GX = range(6)
GEOM_VALID, GEOM_LEVEL, GEOM_FIELDS = 6, 7, 8


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: float = 56.0) -> torch.Tensor:
    """rois [..., 4] xyxy -> int64 pyramid level in [0, num_levels)."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0]).clamp(min=0.0)
                       * (rois[..., 3] - rois[..., 1]).clamp(min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def default_max_grid(feats_hw: Sequence[Sequence[int]], out_size: int) -> int:
    """Samples per bin axis that make the adaptive grid exact for every roi
    the level mapping produces at aspect ratio <= 3: a bin of an unclamped
    level spans under 2 * 56 * sqrt(3) / (4 * out_size) cells (7 slots); on
    the clamped top level a roi spans at most the level itself."""
    h_top, w_top = feats_hw[-1][0], feats_hw[-1][1]
    return max(7, int(math.ceil(max(h_top, w_top) / out_size)))


def roi_geometry(
    rois: torch.Tensor,
    roi_valid: Optional[torch.Tensor],
    feats_hw: Sequence[Sequence[int]],
    strides: Sequence[int] = (4, 8, 16, 32),
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    max_grid: Optional[int] = None,
):
    """rois [B, P, 4] (image coordinates), roi_valid [B, P] or None ->
    (geometry [B, P, GEOM_FIELDS] fp32 contiguous, smax): per roi its
    aligned top-left corner in its level's cells, bin sizes, samples per bin
    and axis (gy, gx), validity and level; ``smax`` bounds gy and gx."""
    num_levels = len(strides)
    rois = rois.float()
    lvl = map_roi_levels(rois, num_levels, finest_scale)
    stride = torch.tensor(list(strides), dtype=torch.float32,
                          device=rois.device)[lvl]
    scale = 1.0 / stride
    x1 = rois[..., 0] * scale - 0.5
    y1 = rois[..., 1] * scale - 0.5
    x2 = rois[..., 2] * scale - 0.5
    y2 = rois[..., 3] * scale - 0.5
    bin_y = (y2 - y1) / out_size
    bin_x = (x2 - x1) / out_size
    if sampling_ratio > 0:
        smax = int(sampling_ratio)
        gy = torch.full_like(y1, smax)
        gx = torch.full_like(x1, smax)
    else:
        smax = (int(max_grid) if max_grid is not None
                else default_max_grid(feats_hw, out_size))
        gy = torch.ceil(bin_y).clamp(1, smax)
        gx = torch.ceil(bin_x).clamp(1, smax)
    valid = (torch.ones_like(y1) if roi_valid is None
             else roi_valid.to(device=rois.device, dtype=torch.float32))
    geom = torch.stack([y1, x1, bin_y, bin_x, gy, gx, valid, lvl.float()],
                       dim=-1)
    return geom.contiguous(), smax


def roi_footprint(geom: torch.Tensor, feats_hw: Sequence[Sequence[int]],
                  out_size: int, smax: int) -> torch.Tensor:
    """The cells each roi's samples can reach: geometry [B, P, GEOM_FIELDS]
    from :func:`roi_geometry` -> int32 [B * P, 4] boxes (y0, y1, x0, x1),
    half-open, in cells of the roi's level.

    A box spans, along each axis, the low cell of the first live sample
    slot to the high neighbour of the last one, with the slots and border
    rules of :func:`axis_samples` (a live slot has ``i < g`` and a sample
    inside [-1, n], clamped to [0, n - 1]; its high neighbour is
    ``min(low + 1, n - 1)``) computed in the same fp32 operations.  So it
    holds every cell the roi gives a weight, and reaches at most one cell
    past them on the high side (a last sample on a cell boundary gives its
    high neighbour no weight).  An invalid roi, or one with no live slot
    on an axis, gets the empty box (0, 0, 0, 0).  The plain version of the
    boxes the backward kernel computes for itself (``chip_smoke.py`` and
    ``tests/test_torch_gpu.py`` hold the two equal on the card); tensor
    operations on the geometry's device, as :func:`roi_geometry`'s."""
    g = geom.reshape(-1, GEOM_FIELDS).float()[:, :, None, None]
    dev = g.device
    sizes = torch.tensor([[int(h), int(w)] for h, w in feats_hw],
                         dtype=torch.float32, device=dev)
    n = sizes[g[:, GEOM_LEVEL, 0, 0].long()][:, :, None, None]  # [R, 2, 1, 1]
    start = g[:, GEOM_Y1:GEOM_X1 + 1]
    bin_size = g[:, GEOM_BIN_Y:GEOM_BIN_X + 1]
    gf = g[:, GEOM_GY:GEOM_GX + 1]
    i = torch.arange(smax, dtype=torch.float32, device=dev)
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    t = start + (o + (i + 0.5) / gf) * bin_size  # [R, 2, O, smax]
    live = (t >= -1.0) & (t <= n) & (i < gf)
    lo = torch.floor(torch.minimum(torch.maximum(t, torch.zeros_like(t)),
                                   n - 1.0))
    hi = torch.minimum(lo + 1.0, n - 1.0)
    first = torch.where(live, lo, math.inf).flatten(2).amin(-1)  # [R, 2]
    end = torch.where(live, hi, -1.0).flatten(2).amax(-1) + 1.0
    keep = (first < end).all(-1) & (g[:, GEOM_VALID, 0, 0] != 0)
    box = torch.stack([first, end], -1).reshape(-1, 4)
    return torch.where(keep[:, None], box, 0.0).int()


def axis_samples(start: torch.Tensor, bin_size: torch.Tensor,
                 g: torch.Tensor, size: torch.Tensor, out_size: int,
                 smax: int):
    """One axis of every roi's sample grid.  start, bin_size, g [R] fp32,
    size [R] (the level's extent along the axis) -> (lo, hi int64, w_lo,
    w_hi fp32), each [R, out_size, smax]: slot (o, i) samples
    ``start + (o + (i + 0.5) / g) * bin_size`` and weighs its two
    neighbouring cells with the bilinear hats times ``(i < g) / g`` (zero
    when the sample is out of range)."""
    dev = start.device
    i = torch.arange(smax, dtype=torch.float32, device=dev)
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    gf = g[:, None]
    inner = (i + 0.5) / gf  # [R, smax]
    frac = o[:, None] + inner[:, None, :]  # [R, O, smax]
    t = start[:, None, None] + frac * bin_size[:, None, None]
    slot_w = torch.where(i < gf, 1.0 / gf, 0.0)[:, None, :]
    n = size.float()[:, None, None]
    ok = (t >= -1.0) & (t <= n)
    tc = torch.minimum(torch.maximum(t, torch.zeros_like(t)), n - 1.0)
    lo = torch.floor(tc)
    hi = torch.minimum(lo + 1.0, n - 1.0)
    w_hi = tc - lo
    w_lo = torch.where(ok, 1.0 - w_hi, 0.0) * slot_w
    w_hi = torch.where(ok, w_hi, 0.0) * slot_w
    return lo.long(), hi.long(), w_lo, w_hi


def axis_weights(start: torch.Tensor, bin_size: torch.Tensor,
                 g: torch.Tensor, size: torch.Tensor, out_size: int,
                 smax: int, cells: int) -> torch.Tensor:
    """One axis of every roi's pooling as a matrix: the arguments of
    :func:`axis_samples` and a cell count -> fp32 [R, out_size, cells],
    entry [r, o, e] the weight bin o of roi r puts on cell e (zero past the
    level): its slots' bilinear weights on that cell summed in slot order,
    low then high neighbour, as the CUDA forward folds them (a row of the
    JAX kernel's ``_axis_matrix``, over every cell: no patch).  RoIAlign is
    then ``Ay @ feat @ Ax^T`` per roi and channel."""
    lo, hi, w_lo, w_hi = axis_samples(start, bin_size, g, size, out_size,
                                      smax)
    e = torch.arange(cells, device=start.device)
    a = torch.zeros(start.shape[0], out_size, cells, device=start.device)
    for i in range(smax):
        a = a + torch.where(lo[..., i, None] == e, w_lo[..., i, None], 0.0)
        a = a + torch.where(hi[..., i, None] == e, w_hi[..., i, None], 0.0)
    return a


def roi_align_reference(feats: Sequence[torch.Tensor], geom: torch.Tensor,
                        out_size: int, smax: int) -> torch.Tensor:
    """Plain PyTorch version of the RoIAlign kernel: feats per level
    [B, H_l, W_l, C] (any float dtype, widened to fp32), geometry from
    :func:`roi_geometry` -> [B, P, out, out, C] in the features' dtype,
    summed in fp32.  One gather of a [R, out, out]
    index per bilinear corner and sample slot pair."""
    b, c = feats[0].shape[0], feats[0].shape[-1]
    p = geom.shape[1]
    r = b * p
    dev = feats[0].device
    heights = torch.tensor([f.shape[1] for f in feats], device=dev)
    widths = torch.tensor([f.shape[2] for f in feats], device=dev)
    sizes = heights * widths
    offsets = torch.cumsum(sizes, 0) - sizes
    sum_hw = int(sizes.sum())
    flat = torch.cat([f.reshape(b, -1, c).float() for f in feats],
                     dim=1).reshape(b * sum_hw, c)
    g = geom.reshape(r, GEOM_FIELDS).to(dev)
    lvl = g[:, GEOM_LEVEL].long()
    h_l, w_l = heights[lvl], widths[lvl]
    off = offsets[lvl] + torch.arange(b, device=dev).repeat_interleave(p) \
        * sum_hw
    ylo, yhi, wylo, wyhi = axis_samples(g[:, GEOM_Y1], g[:, GEOM_BIN_Y],
                                        g[:, GEOM_GY], h_l, out_size, smax)
    xlo, xhi, wxlo, wxhi = axis_samples(g[:, GEOM_X1], g[:, GEOM_BIN_X],
                                        g[:, GEOM_GX], w_l, out_size, smax)
    o = out_size

    def corner(yi, xi, wy, wx):
        idx = (off[:, None, None] + yi[:, :, None] * w_l[:, None, None]
               + xi[:, None, :])  # [R, O, O]
        vals = flat[idx.reshape(-1)].reshape(r, o, o, c)
        return vals * (wy[:, :, None] * wx[:, None, :])[..., None]

    acc = torch.zeros(r, o, o, c, device=dev)
    # slots past the largest g weigh nothing anywhere: skip them
    ny = int(g[:, GEOM_GY].max().item()) if r else 0
    nx = int(g[:, GEOM_GX].max().item()) if r else 0
    for i in range(ny):
        for j in range(nx):
            sl = (slice(None), slice(None), i)
            sm = (slice(None), slice(None), j)
            acc += (corner(ylo[sl], xlo[sm], wylo[sl], wxlo[sm])
                    + corner(ylo[sl], xhi[sm], wylo[sl], wxhi[sm])
                    + corner(yhi[sl], xlo[sm], wyhi[sl], wxlo[sm])
                    + corner(yhi[sl], xhi[sm], wyhi[sl], wxhi[sm]))
    acc = acc * g[:, GEOM_VALID, None, None, None]
    return acc.reshape(b, p, o, o, c).to(feats[0].dtype)


def roi_align_backward_reference(grad: torch.Tensor, geom: torch.Tensor,
                                 feats_hw: Sequence[Sequence[int]],
                                 out_size: int, smax: int) -> list:
    """Plain PyTorch version of the RoIAlign backward kernel, the transpose
    of :func:`roi_align_reference`: the cotangent grad [B, P, out, out, C]
    and the forward's geometry -> the fp32 gradient of each level
    [B, H_l, W_l, C] (``feats_hw`` gives (H_l, W_l)).  The same samples and
    corners as the forward, each scattered with ``index_add_`` into one flat
    fp32 pyramid; rois whose valid is 0 add nothing."""
    b, p, c = grad.shape[0], grad.shape[1], grad.shape[-1]
    r = b * p
    dev = grad.device
    heights = torch.tensor([int(h) for h, _ in feats_hw], device=dev)
    widths = torch.tensor([int(w) for _, w in feats_hw], device=dev)
    sizes = heights * widths
    offsets = torch.cumsum(sizes, 0) - sizes
    sum_hw = int(sizes.sum())
    g = geom.reshape(r, GEOM_FIELDS).to(dev)
    lvl = g[:, GEOM_LEVEL].long()
    h_l, w_l = heights[lvl], widths[lvl]
    off = offsets[lvl] + torch.arange(b, device=dev).repeat_interleave(p) \
        * sum_hw
    ylo, yhi, wylo, wyhi = axis_samples(g[:, GEOM_Y1], g[:, GEOM_BIN_Y],
                                        g[:, GEOM_GY], h_l, out_size, smax)
    xlo, xhi, wxlo, wxhi = axis_samples(g[:, GEOM_X1], g[:, GEOM_BIN_X],
                                        g[:, GEOM_GX], w_l, out_size, smax)
    o = out_size
    gv = grad.reshape(r, o, o, c).float() * g[:, GEOM_VALID, None, None, None]
    flat = torch.zeros(b * sum_hw, c, device=dev)

    def corner(yi, xi, wy, wx):
        idx = (off[:, None, None] + yi[:, :, None] * w_l[:, None, None]
               + xi[:, None, :])  # [R, O, O]
        vals = gv * (wy[:, :, None] * wx[:, None, :])[..., None]
        flat.index_add_(0, idx.reshape(-1), vals.reshape(-1, c))

    ny = int(g[:, GEOM_GY].max().item()) if r else 0
    nx = int(g[:, GEOM_GX].max().item()) if r else 0
    for i in range(ny):
        for j in range(nx):
            sl = (slice(None), slice(None), i)
            sm = (slice(None), slice(None), j)
            corner(ylo[sl], xlo[sm], wylo[sl], wxlo[sm])
            corner(ylo[sl], xhi[sm], wylo[sl], wxhi[sm])
            corner(yhi[sl], xlo[sm], wyhi[sl], wxlo[sm])
            corner(yhi[sl], xhi[sm], wyhi[sl], wxhi[sm])
    levels = flat.reshape(b, sum_hw, c).split(sizes.tolist(), dim=1)
    return [lv.reshape(b, int(h), int(w), c)
            for lv, (h, w) in zip(levels, feats_hw)]


def batched_roi_align(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    roi_valid: Optional[torch.Tensor] = None,
    strides: Sequence[int] = (4, 8, 16, 32),
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    max_grid: Optional[int] = None,
) -> torch.Tensor:
    """feats per level [B, H_l, W_l, C]; rois [B, P, 4] xyxy in image
    coordinates; roi_valid [B, P] -> [B, P, out, out, C] with invalid rows
    zeroed, always through the plain version (the counterpart of the JAX
    package's ``batched_roi_align``; ``kernels.roi_align_patch`` is the
    kernel's wrapper)."""
    if len(feats) != len(strides):
        raise ValueError(f"{len(feats)} levels vs {len(strides)} strides")
    geom, smax = roi_geometry(rois, roi_valid, [f.shape[1:3] for f in feats],
                              strides, out_size, sampling_ratio,
                              finest_scale, max_grid)
    return roi_align_reference(feats, geom, out_size, smax)
