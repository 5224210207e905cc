"""The linear layer-attention family as ``nn.Module``s: full-rank
(``LinearLayerAttention``, optionally carrying its state as an SVD),
channel-wise (``LinearCLA``) and group-wise (``LinearGLA``).

Each holds the MRLA projections (``Wq``, ``Wk`` k-tap channel convs,
``Wv`` depthwise 3x3; the init of ``nn/layers.py``) and threads the
running state (s, z) through its caller, as the MRLA-base cache is:
``forward(x, s, z) -> (out, s, z)``, None starting the recurrence.  The
modules take and return NCHW views of NHWC memory, as ``nn.Conv2d``.
φ is named by ``feature_map`` (``FEATURE_MAPS``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mrla_tpu_torch.nn.layers import _Projections
from mrla_tpu_torch.ops.linear_la import (
    elu_feature_map,
    linear_cla_step,
    linear_gla_step,
    linear_la_step,
)

FEATURE_MAPS: Dict[str, Callable] = {"elu": elu_feature_map}


class _LinearLA(_Projections):
    def __init__(self, channels: int, feature_map: str = "elu",
                 eps: float = 1e-6, k_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, heads=1, k_size=k_size,
                         generator=generator)
        self.phi, self.eps = FEATURE_MAPS[feature_map], eps

    def forward(self, x: torch.Tensor, s, z):
        out, s, z = self.step(x.permute(0, 2, 3, 1), s, z)
        return out.permute(0, 3, 1, 2), s, z


class LinearLayerAttention(_LinearLA):
    """Full-rank linear LA: s [B, C, C·H·W].  ``svd`` carries s factorised
    between layers; ``svd_rank`` truncates it."""

    def __init__(self, channels: int, feature_map: str = "elu",
                 eps: float = 1e-6, k_size: Optional[int] = None,
                 svd: bool = False, svd_rank: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, feature_map, eps, k_size, generator)
        self.svd, self.svd_rank = svd, svd_rank

    def step(self, x, s, z):
        return linear_la_step(x, s, z, self.params(), self.phi, self.eps,
                              self.svd, self.svd_rank)


class LinearCLA(_LinearLA):
    """Channel-wise linear LA (a head a channel)."""

    def step(self, x, s, z):
        return linear_cla_step(x, s, z, self.params(), self.phi, self.eps)


class LinearGLA(_LinearLA):
    """Group-wise linear LA: ``groups`` groups, or C / ``dim_pergroup``."""

    def __init__(self, channels: int, groups: Optional[int] = None,
                 dim_pergroup: Optional[int] = None,
                 feature_map: str = "elu", eps: float = 1e-6,
                 k_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        if groups is None and dim_pergroup is None:
            raise ValueError("one of groups / dim_pergroup must be given")
        super().__init__(channels, feature_map, eps, k_size, generator)
        self.groups = groups if groups is not None else channels // dim_pergroup

    def step(self, x, s, z):
        return linear_gla_step(x, s, z, self.params(), self.groups,
                               self.phi, self.eps)
