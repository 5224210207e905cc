"""Shared primitives for the MRLA op family (PyTorch, NHWC at the API).

The public functions take and return NHWC tensors, as the JAX package's
ops do.  Convolutions run on ``x.permute(0, 3, 1, 2)`` views: a contiguous
NHWC tensor viewed that way has channels_last strides, so the convolution
reads NHWC memory and its output permutes back to a contiguous NHWC tensor
without a copy.

Weights keep PyTorch's layouts: ``channel_conv1d`` takes the k taps of a
``Conv1d(1, 1, k)`` weight (any shape with k elements), and
``depthwise_conv3x3`` a ``Conv2d(C, C, 3, groups=C)`` weight [C, 1, 3, 3].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def eca_kernel_size(channels: int) -> int:
    """Adaptive 1-D kernel size over the channel axis (ECA heuristic):
    k = t if t is odd else t + 1, with t = int(|log2(C) + 1| / 2)."""
    t = int(abs((math.log2(channels) + 1) / 2.0))
    return t if t % 2 else t + 1


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, C] spatial mean, taken in float32 whatever
    the input dtype (it feeds the tiny Q/K projections)."""
    return torch.mean(x, dim=(1, 2), dtype=torch.float32)


def rowwise(fn, y: torch.Tensor) -> torch.Tensor:
    """The elementwise ``fn`` of a [..., n] tensor, on the CPU with its
    rows padded to a multiple of 64 elements.  A CPU elementwise kernel
    takes whole chunks in a vector loop and the tail on a scalar path,
    which may round a transcendental (exp, sigmoid) otherwise; with padded
    rows every element lies in a whole chunk, so a row's bits do not depend
    on how many rows the batch has (microbatch chains,
    ``serving/microbatch.py``).  A CUDA kernel computes every element with
    the same code, so there the rows go as they are (no extra launches)."""
    pad = -y.shape[-1] % 64
    if pad == 0 or y.device.type != "cpu":
        return fn(y)
    return fn(F.pad(y, (0, pad)))[..., :y.shape[-1]]


def channel_conv1d(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free SAME-padded cross-correlation of a [..., C] descriptor with
    k taps along the channel axis: ``Conv1d(1, 1, k, padding=(k-1)//2,
    bias=False)`` applied to a [N, 1, C] view, in ``y``'s dtype (also
    under ``torch.autocast``).  Returns [..., C]."""
    taps = w.reshape(1, 1, -1).to(y.dtype)
    k = taps.shape[-1]
    c = y.shape[-1]
    with torch.autocast(y.device.type, enabled=False):
        out = F.conv1d(y.reshape(-1, 1, c), taps, padding=(k - 1) // 2)
    return out.reshape(y.shape)


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 SAME conv on NHWC input (the MRLA value projection Wv).

    ``w`` is the [C, 1, 3, 3] weight of ``Conv2d(C, C, 3, padding=1,
    groups=C, bias=False)``; it is cast to the input's dtype."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, b=None,
                stride: int = 1) -> torch.Tensor:
    """NHWC conv with a torch-layout weight [O, I, kh, kw] and symmetric
    padding kh // 2 on each side; returns NHWC (a view of channels_last
    memory)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                 padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def max_pool_same_torch(x: torch.Tensor, window: int = 3,
                        stride: int = 2) -> torch.Tensor:
    """``MaxPool2d(window, stride, padding=(window-1)//2)`` on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                     padding=(window - 1) // 2)
    return y.permute(0, 2, 3, 1)
