"""Functional MRLA-light attention (NHWC, PyTorch).

MRLA-light (paper eq. 8): a per-head sigmoid gate on the single-position
Q·K product of the GAP descriptor scales a depthwise-3x3 value map.  The
heads own contiguous blocks of d = C / heads channels, so the [B, heads]
gate is broadcast to [B, C] by repeating each head's value d times.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    depthwise_conv3x3,
    global_avg_pool,
)


class MRLAParams(NamedTuple):
    """Weights of one MRLA attention layer.

    wq, wk: the k channel-axis taps (any shape with k elements).
    wv:     [C, 1, 3, 3] depthwise value kernel.
    """

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor


def mrla_light_attention(x: torch.Tensor, params: MRLAParams, heads: int,
                         act_v: Optional[Callable] = None) -> torch.Tensor:
    """[B, H, W, C] block output -> [B, H, W, C] gated value map (the caller
    adds λ ⊙ o_{t-1}).  ``act_v``, if given, is applied to V before the gate
    (the DeiT variant passes the exact-erf GELU)."""
    b, c = x.shape[0], x.shape[-1]
    d = c // heads
    y = global_avg_pool(x)  # [B, C] fp32
    q = channel_conv1d(y, params.wq.float()).reshape(b, heads, d)
    k = channel_conv1d(y, params.wk.float()).reshape(b, heads, d)
    attn = torch.sigmoid((q * k).sum(-1) * (1.0 / math.sqrt(d)))  # [B, g]
    v = depthwise_conv3x3(x, params.wv)
    if act_v is not None:
        v = act_v(v)
    gate = attn.repeat_interleave(d, dim=-1).to(v.dtype)  # [B, C]
    return v * gate[:, None, None, :]
