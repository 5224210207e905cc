"""Feature Pyramid Network neck (MMDetection ``FPN`` semantics), PyTorch.

The two-stage presets' neck (faster_rcnn_r50mrlal_fpn.py:15-19):
in_channels [256, 512, 1024, 2048], out_channels 256, num_outs 5,
``add_extra_convs=None``: a 1x1 lateral conv on each input, a top-down
pathway that adds each level's nearest upsample (to the exact size below,
as mmdet's ``interpolate(size=...)``) into the level below, a 3x3 output
conv per level, and the extra level as a stride-2 max pool of window 1 on
the last output.  No norm layers.  ``state_dict`` keys are mmdet's:
``lateral_convs.{i}.conv.*`` and ``fpn_convs.{i}.conv.*``.

:func:`fpn_forward` is the neck as a function of its weights, shared by
the module and the serving engine.  RetinaNet's neck (``start_level=1``,
``add_extra_convs='on_input'``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from mrla_tpu_torch.ops.common import conv2d_nhwc


def upsample_nearest_to(x: torch.Tensor, h_out: int, w_out: int
                        ) -> torch.Tensor:
    """Nearest upsample of NHWC ``x`` to exactly (h_out, w_out): source row
    ``floor(i * (h / h_out))`` in fp32, as the JAX package computes it."""
    b, h, w, c = x.shape
    if (h_out, w_out) == (2 * h, 2 * w):
        return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
            b, 2 * h, 2 * w, c)

    def src(n_out, n):
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor(pos * torch.tensor(n / n_out, dtype=torch.float32,
                                              device=x.device)).long()

    return x[:, src(h_out, h)][:, :, src(w_out, w)]


def fpn_forward(neck: Dict, inputs: Sequence[torch.Tensor],
                num_outs: int = 5) -> tuple:
    """The neck on NHWC ``inputs`` with weights ``neck`` = {"lateral":
    [(w, b)], "fpn": [(w, b)]} in the torch layout -> ``num_outs`` NHWC
    levels."""
    used = list(inputs)[:num_outs]
    n = len(used)
    laterals = [conv2d_nhwc(used[i], *neck["lateral"][i]) for i in range(n)]
    for i in range(n - 1, 0, -1):
        _, th, tw, _ = laterals[i - 1].shape
        laterals[i - 1] = laterals[i - 1] + upsample_nearest_to(
            laterals[i], th, tw)
    outs = [conv2d_nhwc(laterals[i], *neck["fpn"][i]) for i in range(n)]
    while len(outs) < num_outs:  # max pool, window 1, stride 2
        outs.append(outs[-1][:, ::2, ::2])
    return tuple(outs)


class ConvModule(nn.Module):
    """mmdet ``ConvModule`` without norm or activation: ``.conv`` only."""

    def __init__(self, in_ch: int, out_ch: int, k: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, padding=k // 2)
        xavier_uniform(self.conv, generator)


def xavier_uniform(layer: nn.Module,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """mmdet's default for the neck and the heads' fcs: Xavier-uniform
    weight, zero bias."""
    w = layer.weight
    fan_in = w.shape[1] * w[0, 0].numel()
    fan_out = w.shape[0] * w[0, 0].numel()
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        w.uniform_(-lim, lim, generator=generator)
        layer.bias.zero_()
    return layer


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_outs = num_outs
        used = list(in_channels)[:num_outs]
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1, generator) for c in used])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, generator)
             for _ in used])

    def weights(self) -> Dict:
        return {"lateral": [(m.conv.weight, m.conv.bias)
                            for m in self.lateral_convs],
                "fpn": [(m.conv.weight, m.conv.bias) for m in self.fpn_convs]}

    def forward(self, inputs: Sequence[torch.Tensor]) -> tuple:
        """NHWC (C2, C3, C4, C5) -> NHWC (P2, .., P6)."""
        return fpn_forward(self.weights(), inputs, self.num_outs)
