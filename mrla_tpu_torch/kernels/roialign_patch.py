"""Multi-level aligned RoIAlign as CUDA kernels (forward and backward),
with their plain versions.

``roi_align_patch`` is the counterpart of the JAX package's
``roi_align_patch`` (``mrla_tpu/kernels/roialign_patch.py``) and takes the
same arguments: feats per level [B, H_l, W_l, C] (NHWC), rois [B, P, 4]
xyxy in image coordinates, roi_valid [B, P] -> [B, P, out, out, C].  The
per-roi geometry comes from ``detect.roi_align.roi_geometry`` (one small
[B, P, 8] fp32 array); the kernels (``csrc/roi_align.cu``) and the plain
versions ``detect.roi_align.roi_align_reference`` /
``roi_align_backward_reference`` all read it.  Unlike the TPU kernel there
is no 56-cell patch (so no coverage limit), no 8-aligned column origin and
no C % 128 condition: the forward takes C % 8 == 0, one to four levels, and
bf16 or fp32 features, with the output in the features' dtype.  Its C entry
point rejects the rest with cudaErrorInvalidValue (1), and the wrapper
raises.

Autograd: ``roi_align_patch`` is one ``torch.autograd.Function`` on both
devices, as the JAX function is a custom VJP.  Its forward computes the
geometry once and saves only that (no activation); its backward computes
the fp32 gradient of each level, through the backward kernel
(``roi_align_grad_kernel``; fp32 cotangent, C % 8 == 0) for CUDA tensors
or ``roi_align_backward_reference`` for CPU tensors, and casts it to each
level's dtype.  The backward kernel writes every gradient cell once, from
the block that owns it, summing in a fixed order: two launches on the same
inputs give the same bits.  Which rois reach a block it reads from their
boxes, which it computes first as ``detect.roi_align.roi_footprint`` does
(the boxes' plain version).  No gradient goes to ``rois`` or
``roi_valid`` (they are detached), as in mmcv and the JAX VJP.

For CPU tensors the wrapper runs the plain versions; for CUDA tensors it
launches the kernels or raises.  ``roi_align_patch.counter`` counts calls
and launches of both kernels: forward launches by (B, P, out, C), backward
launches by ("bwd", B, P, out, C).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from mrla_tpu_torch.detect.roi_align import (
    roi_align_backward_reference,
    roi_align_reference,
    roi_geometry,
)
from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import use_plain_version

MAX_LEVELS = 4
_DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def _level_dims(feats_hw: Sequence[Sequence[int]]) -> List[int]:
    """(H, W) of 4 levels as the C entry points take them, 0 past L."""
    dims = []
    for i in range(MAX_LEVELS):
        dims += [int(v) for v in feats_hw[i]] if i < len(feats_hw) else [0, 0]
    return dims


def roi_align_kernel(feats: Sequence[torch.Tensor], geom: torch.Tensor,
                     out_size: int, smax: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with a given geometry (what
    ``roi_align_patch`` does after ``roi_geometry``); counts the launch."""
    b, c = feats[0].shape[0], feats[0].shape[-1]
    p = geom.shape[1]
    dev = feats[0].device
    for i, f in enumerate(feats):
        if f.dtype not in _DTYPE_FLAG or f.dtype != feats[0].dtype:
            raise TypeError(f"level {i}: features must all be bfloat16 or "
                            f"all float32, got {f.dtype}")
        if f.device != dev or not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError(f"level {i} must be a contiguous, 16-byte "
                             f"aligned NHWC tensor on {dev}")
    geom = geom.to(dev, torch.float32).contiguous()
    out = torch.empty((b, p, out_size, out_size, c), dtype=feats[0].dtype,
                      device=dev)
    ptrs = [f.data_ptr() for f in feats] + [None] * (MAX_LEVELS - len(feats))
    dims = _level_dims([f.shape[1:3] for f in feats])
    with torch.cuda.device(dev):
        err = library().roi_align_fwd(
            *ptrs, *dims, len(feats), geom.data_ptr(), out.data_ptr(), b, p,
            c, out_size, smax, _DTYPE_FLAG[feats[0].dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"roi_align_fwd (C={c}, out={out_size}, smax={smax})")
    roi_align_patch.counter.launch((b, p, out_size, c))
    return out


def grad_scratch(grad: torch.Tensor, feats_hw: Sequence[Sequence[int]],
                 lib=None, fill: Optional[int] = None) -> torch.Tensor:
    """The backward kernel's scratch buffer for a cotangent like ``grad``
    (uint8, uncleared unless ``fill`` gives a byte); ``lib`` is the kernel
    library (default ``library()``).  It starts with the rois' boxes:
    ``scratch_boxes``."""
    lib = lib or library()
    b, p, o, _, c = grad.shape
    n = lib.roi_align_bwd_scratch_bytes(b, p, c, o, *_level_dims(feats_hw),
                                        len(feats_hw))
    if fill is None:
        return torch.empty(max(n, 1), dtype=torch.uint8, device=grad.device)
    return torch.full((max(n, 1),), fill, dtype=torch.uint8,
                      device=grad.device)


def scratch_boxes(scratch: torch.Tensor, rois: int) -> torch.Tensor:
    """The rois' boxes [rois, 4] int32 (y0, y1, x0, x1) that the backward
    kernel wrote at the start of its scratch buffer."""
    return scratch[:16 * rois].view(torch.int32).reshape(rois, 4)


def launch_grad(grads: Sequence[torch.Tensor], geom: torch.Tensor,
                grad: torch.Tensor, scratch: torch.Tensor, smax: int,
                lib=None) -> int:
    """The backward's C entry point on given level buffers and scratch (a
    CUDA cotangent, fp32, contiguous): its cudaError."""
    lib = lib or library()
    b, p, o, _, c = grad.shape
    hw = [g.shape[1:3] for g in grads]
    ptrs = [g.data_ptr() for g in grads] + [None] * (MAX_LEVELS - len(grads))
    with torch.cuda.device(grad.device):
        return lib.roi_align_bwd(
            *ptrs, *_level_dims(hw), len(grads), geom.data_ptr(),
            grad.data_ptr(), scratch.data_ptr(), b, p, c, o, smax,
            torch.cuda.current_stream().cuda_stream)


def roi_align_grad_kernel(grad: torch.Tensor, geom: torch.Tensor,
                          feats_hw: Sequence[Sequence[int]],
                          smax: int) -> List[torch.Tensor]:
    """Launch the backward kernel on a CUDA cotangent grad [B, P, out, out,
    C] (fp32) with the forward's geometry -> the fp32 gradient of each level
    [B, H_l, W_l, C].  The kernel fills a scratch buffer (the rois' boxes as
    ``roi_footprint`` computes them, which tell each tile of the levels
    which rois reach it; their cells' bins; the narrow rois' folded rows)
    and writes every cell of the level buffers, so all are allocated
    uncleared.  Counts the launch under ("bwd", B, P, out, C)."""
    if grad.dtype != torch.float32:
        raise TypeError(f"the cotangent must be float32, got {grad.dtype}")
    if not 1 <= len(feats_hw) <= MAX_LEVELS:
        raise ValueError(f"{len(feats_hw)} levels; 1 to {MAX_LEVELS} taken")
    b, p, o, _, c = grad.shape
    dev = grad.device
    grad = grad.contiguous()
    geom = geom.to(dev, torch.float32).contiguous()
    grads = [torch.empty((b, int(h), int(w), c), dtype=torch.float32,
                         device=dev) for h, w in feats_hw]
    err = launch_grad(grads, geom, grad, grad_scratch(grad, feats_hw), smax)
    check(err, f"roi_align_bwd (C={c}, out={o}, smax={smax})")
    roi_align_patch.counter.launch(("bwd", b, p, o, c))
    return grads


class _RoIAlign(torch.autograd.Function):
    """RoIAlign on given geometry; the gradient goes to the levels only."""

    @staticmethod
    def forward(ctx, geom, out_size, smax, *feats):
        ctx.save_for_backward(geom)
        ctx.out_size, ctx.smax = out_size, smax
        ctx.levels = [(f.shape[1], f.shape[2], f.dtype) for f in feats]
        if use_plain_version(feats[0]):
            return roi_align_reference(feats, geom, out_size, smax)
        return roi_align_kernel(feats, geom, out_size, smax)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (geom,) = ctx.saved_tensors
        hw = [(h, w) for h, w, _ in ctx.levels]
        if use_plain_version(grad):
            grads = roi_align_backward_reference(grad, geom, hw, ctx.out_size,
                                                 ctx.smax)
        else:
            grads = roi_align_grad_kernel(grad.float(), geom, hw, ctx.smax)
        return (None, None, None,
                *(g.to(dt) for g, (_, _, dt) in zip(grads, ctx.levels)))


def roi_align_patch(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    roi_valid: Optional[torch.Tensor] = None,
    strides: Sequence[int] = (4, 8, 16, 32),
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
    max_grid: Optional[int] = None,
) -> torch.Tensor:
    """RoIAlign of ``rois`` on the pyramid ``feats`` ->
    [B, P, out_size, out_size, C] in the features' dtype;
    ``sampling_ratio=0`` is the adaptive grid.  Differentiable with respect
    to ``feats``."""
    roi_align_patch.counter.calls += 1
    if not 1 <= len(feats) <= MAX_LEVELS or len(feats) != len(strides):
        raise ValueError(f"{len(feats)} levels and {len(strides)} strides; "
                         f"1 to {MAX_LEVELS} of each are taken")
    b, c = feats[0].shape[0], feats[0].shape[-1]
    for i, f in enumerate(feats):
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level {i} must be [{b}, H, W, {c}], got "
                             f"{tuple(f.shape)}")
    if rois.dim() != 3 or tuple(rois.shape[::2]) != (b, 4):
        raise ValueError(f"rois must be [{b}, P, 4], got {tuple(rois.shape)}")
    geom, smax = roi_geometry(
        rois.detach(), None if roi_valid is None else roi_valid.detach(),
        [f.shape[1:3] for f in feats], strides, out_size, sampling_ratio,
        finest_scale, max_grid)
    return _RoIAlign.apply(geom, out_size, smax, *feats)


roi_align_patch.counter = LaunchCounter()
