"""Multi-level aligned RoIAlign forward as a CUDA kernel, with its plain
version.

``roi_align_patch`` is the counterpart of the JAX package's
``roi_align_patch`` (``mrla_tpu/kernels/roialign_patch.py``) and takes the
same arguments: feats per level [B, H_l, W_l, C] (NHWC), rois [B, P, 4]
xyxy in image coordinates, roi_valid [B, P] -> [B, P, out, out, C].  The
per-roi geometry comes from ``detect.roi_align.roi_geometry`` (one small
[B, P, 8] fp32 array); the kernel (``csrc/roi_align.cu``) and the plain
version ``detect.roi_align.roi_align_reference`` both read it.  Unlike the
TPU kernel there is no 56-cell patch (so no coverage limit), no 8-aligned
column origin and no C % 128 condition: the kernel takes C % 8 == 0, one to
four levels, and bf16 or fp32 features, with the output in the features'
dtype.  Its C entry point rejects the rest with cudaErrorInvalidValue (1),
and the wrapper raises.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises.  ``roi_align_patch.counter`` counts calls
and launches, the launches also by (B, P, out, C).  No gradient: detection
training (the TPU kernel's custom VJP) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mrla_tpu_torch.detect.roi_align import roi_align_reference, roi_geometry
from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import use_plain_version

MAX_LEVELS = 4
_DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


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
    dims = []
    for i in range(MAX_LEVELS):
        dims += list(feats[i].shape[1:3]) if i < len(feats) else [0, 0]
    with torch.cuda.device(dev):
        err = library().roi_align_fwd(
            *ptrs, *dims, len(feats), geom.data_ptr(), out.data_ptr(), b, p,
            c, out_size, smax, _DTYPE_FLAG[feats[0].dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"roi_align_fwd (C={c}, out={out_size}, smax={smax})")
    roi_align_patch.counter.launch((b, p, out_size, c))
    return out


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
    ``sampling_ratio=0`` is the adaptive grid."""
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
    geom, smax = roi_geometry(rois, roi_valid, [f.shape[1:3] for f in feats],
                              strides, out_size, sampling_ratio,
                              finest_scale, max_grid)
    if use_plain_version(feats[0]):
        return roi_align_reference(feats, geom, out_size, smax)
    return roi_align_kernel(feats, geom, out_size, smax)


roi_align_patch.counter = LaunchCounter()
