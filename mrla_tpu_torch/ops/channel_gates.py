"""Channel gates: squeeze-and-excitation (SE) and efficient channel
attention (ECA), NHWC at the API.

Both are GAP -> a tiny projection -> sigmoid -> scale.  The descriptor is
the fp32 global average pool, and the projection runs in fp32 whatever the
activations' dtype (also under ``torch.autocast``), as the JAX package's
gates compute it; the gate is rounded to the activations' dtype once.

SE's projections run as 1x1 convolutions of the [B, C, 1, 1] descriptor:
on the CPU a matrix product of a few rows may round otherwise than one of
many, and a convolution does not; the nonlinearities take rows padded
for the same reason (``ops.common.rowwise``).  So a batch served as
microbatch chains keeps the bits of the unsplit batch
(``serving/microbatch.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    global_avg_pool,
    rowwise,
)


def dense_fp32(y: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y @ w.T + b`` of a [B, C] fp32 descriptor in fp32, ``w`` a
    ``Linear`` weight [O, C] or a 1x1 ``Conv2d`` weight [O, C, 1, 1] (taken
    to fp32 as it is: a bf16 serving weight stays bf16-rounded), as a 1x1
    convolution; autocast is off inside."""
    with torch.autocast(y.device.type, enabled=False):
        out = F.conv2d(y[:, :, None, None],
                       w.float().reshape(w.shape[0], -1, 1, 1),
                       None if b is None else b.float())
    return out[:, :, 0, 0]


def se_gate(x: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """Squeeze-and-excitation on NHWC ``x`` [B, H, W, C]: the bias-free
    projections are ``Linear`` weights, w1 [C // r, C] and w2 [C, C // r]."""
    y = F.relu(dense_fp32(global_avg_pool(x), w1))
    y = rowwise(torch.sigmoid, dense_fp32(y, w2))
    return x * y[:, None, None, :].to(x.dtype)


def eca_gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Efficient channel attention on NHWC ``x`` [B, H, W, C]: ``w`` holds
    the k taps of a ``Conv1d(1, 1, k)`` (a cross-correlation across the
    channel axis, as the JAX package's)."""
    y = rowwise(torch.sigmoid,
                channel_conv1d(global_avg_pool(x), w.float()))
    return x * y[:, None, None, :].to(x.dtype)
