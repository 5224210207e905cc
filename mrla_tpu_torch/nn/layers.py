"""MRLA layers as ``nn.Module``s: MRLA-light, MRLA-base and LA (eq. 4);
the channel gates SE and ECA; and the stochastic layers of training,
``DropPath`` and ``Dropout``.

Parameter names are the reference implementation's, so its published
``state_dict``s load unchanged: ``mrla.Wq.weight`` [1, 1, k],
``mrla.Wk.weight``, ``mrla.Wv.weight`` [C, 1, 3, 3] and ``lambda_t``
[C, 1, 1] (light; base has no λ), and LA's ``W{q,k,v}.weight``; SE's
bias-free ``fc.0.weight`` [C // r, C] and ``fc.2.weight`` [C, C // r],
ECA's ``conv.weight`` [1, 1, k].

Init matches the JAX package: Conv1d-uniform Wq/Wk (U(±1/√k)), kaiming
normal fan_out Wv, λ ~ N(0, 1); SE's Linears U(±1/√fan_in), ECA's taps
U(±1/√k).

The modules take NCHW tensors, as ``nn.Conv2d`` does; the model feeds them
NCHW views of NHWC memory (channels_last strides), and the functional ops
run on the NHWC view of the same memory.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from mrla_tpu_torch.ops.channel_gates import eca_gate, se_gate
from mrla_tpu_torch.ops.common import eca_kernel_size
from mrla_tpu_torch.ops.drop import drop_path, dropout
from mrla_tpu_torch.ops.mrla import (
    MRLACache,
    MRLAParams,
    la_eq4_attention,
    mrla_base_attention,
    mrla_light_attention,
)


def _resolve_heads(channels: int, heads: Optional[int],
                  dim_perhead: Optional[int]) -> int:
    if heads is None and dim_perhead is None:
        raise ValueError("one of heads / dim_perhead must be given")
    if dim_perhead is not None:
        heads = channels // dim_perhead
    if channels % heads != 0:
        raise ValueError(
            f"channels ({channels}) must be divisible by heads ({heads})"
        )
    return heads


class _Projections(nn.Module):
    """The Q / K / V weights every MRLA variant holds: k-tap channel convs
    Wq, Wk and the depthwise 3x3 Wv, with ``heads`` heads."""

    def __init__(self, channels: int, heads: Optional[int] = None,
                 dim_perhead: Optional[int] = None,
                 k_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = _resolve_heads(channels, heads, dim_perhead)
        k = k_size or eca_kernel_size(channels)
        self.Wq = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        self.Wk = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        self.Wv = nn.Conv2d(channels, channels, 3, padding=1,
                            groups=channels, bias=False)
        lim = 1.0 / math.sqrt(k)
        with torch.no_grad():
            self.Wq.weight.uniform_(-lim, lim, generator=generator)
            self.Wk.weight.uniform_(-lim, lim, generator=generator)
            # kaiming normal, fan_out = C·3·3 of the [C, 1, 3, 3] weight
            self.Wv.weight.normal_(0.0, math.sqrt(2.0 / (channels * 9)),
                                   generator=generator)

    def params(self) -> MRLAParams:
        return MRLAParams(self.Wq.weight, self.Wk.weight, self.Wv.weight)


class MRLALightLayer(_Projections):
    """mrla_light_layer: sigmoid-gated single-position layer attention.
    ``act_v`` is applied to V before the gate (DeiT: the exact GELU)."""

    def __init__(self, channels: int, heads: Optional[int] = None,
                 dim_perhead: Optional[int] = None,
                 k_size: Optional[int] = None,
                 act_v: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, heads, dim_perhead, k_size, generator)
        self.act_v = act_v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = mrla_light_attention(x.permute(0, 2, 3, 1), self.params(),
                                 self.heads, act_v=self.act_v)
        return y.permute(0, 3, 1, 2)


class MRLALightModule(nn.Module):
    """mrla_module (light): o_t = attn(x_t) + λ ⊙ o_{t-1}."""

    def __init__(self, channels: int, dim_perhead: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mrla = MRLALightLayer(channels, dim_perhead=dim_perhead,
                                   generator=generator)
        self.lambda_t = nn.Parameter(torch.empty(channels, 1, 1))
        with torch.no_grad():
            self.lambda_t.normal_(0.0, 1.0, generator=generator)

    def forward(self, xt: torch.Tensor, ot_1: torch.Tensor) -> torch.Tensor:
        return self.mrla(xt) + self.lambda_t.to(ot_1.dtype) * ot_1


class MRLABaseLayer(_Projections):
    """mrla_base_layer: attention over the stage's K/V cache, softmax over
    the layer axis.  Takes an NCHW view and the cache (NHWC maps), returns
    (out NCHW, the cache with this layer appended); ``cache=None`` starts a
    stage in buffers for ``max_t`` layers."""

    def forward(self, x: torch.Tensor, cache: Optional[MRLACache],
                max_t: Optional[int] = None):
        y, cache = mrla_base_attention(x.permute(0, 2, 3, 1), self.params(),
                                       self.heads, cache, max_t)
        return y.permute(0, 3, 1, 2), cache


class MRLABaseModule(nn.Module):
    """mrla_module (base): the base layer with ``dim_perhead`` channels a
    head, one channel a head with ``channel_wise``."""

    def __init__(self, channels: int, dim_perhead: int = 16,
                 channel_wise: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mrla = MRLABaseLayer(
            channels, dim_perhead=1 if channel_wise else dim_perhead,
            generator=generator)

    def forward(self, xt: torch.Tensor, cache: Optional[MRLACache],
                max_t: Optional[int] = None):
        return self.mrla(xt, cache, max_t)


class LALayer(_Projections):
    """la_layer (eq. 4): attention of the current map over the stacked
    context of the stage's maps, keys and values recomputed from all of
    them.  Takes NCHW x and the context [B, t, H, W, C] (NHWC maps)."""

    def __init__(self, channels: int, dim_perhead: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, dim_perhead=dim_perhead,
                         generator=generator)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        y = la_eq4_attention(x.permute(0, 2, 3, 1), ctx, self.params(),
                             self.heads)
        return y.permute(0, 3, 1, 2)


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate (reduction 16)."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = channels // reduction
        self.fc = nn.Sequential(nn.Linear(channels, mid, bias=False),
                                nn.ReLU(inplace=True),
                                nn.Linear(mid, channels, bias=False),
                                nn.Sigmoid())
        with torch.no_grad():
            for fc, fan_in in ((self.fc[0], channels), (self.fc[2], mid)):
                lim = 1.0 / math.sqrt(fan_in)
                fc.weight.uniform_(-lim, lim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = se_gate(x.permute(0, 2, 3, 1), self.fc[0].weight,
                    self.fc[2].weight)
        return y.permute(0, 3, 1, 2)


class ECALayer(nn.Module):
    """Efficient channel attention with ``k_size`` taps (the ECA kernel-size
    heuristic of the channel count when None)."""

    def __init__(self, channels: int, k_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = k_size or eca_kernel_size(channels)
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        lim = 1.0 / math.sqrt(k)
        with torch.no_grad():
            self.conv.weight.uniform_(-lim, lim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = eca_gate(x.permute(0, 2, 3, 1), self.conv.weight)
        return y.permute(0, 3, 1, 2)


class DropPath(nn.Module):
    """Per-sample stochastic depth at ``rate``; the identity in eval mode or
    at rate 0.  Its masks come from ``generator``, which the trainer sets
    (``set_generator``); the module holds none of its own."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.rate, self.generator, self.training)


class Dropout(nn.Module):
    """Element-wise dropout at ``p`` with masks from ``generator`` (as
    ``DropPath``)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.generator, self.training)


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> nn.Module:
    """Hand ``generator`` to every ``DropPath`` and ``Dropout`` in
    ``model``; their draws then follow the forward's order."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
    return model
