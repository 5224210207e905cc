"""Stochastic depth (per-sample DropPath) and dropout with explicit
generators.

A binary keep mask, per sample for ``drop_path`` and per element for
``dropout``, with the kept values scaled by 1 / keep.  Every draw comes
from the ``generator`` the caller hands in, never from torch's global RNG
(``F.dropout`` takes no generator, so the mask is drawn here).  In eval mode
(``training=False``) or at rate 0 both are the identity.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked(x: torch.Tensor, rate: float, shape,
            generator: Optional[torch.Generator], what: str) -> torch.Tensor:
    if generator is None:
        raise ValueError(f"{what} needs a generator in training mode "
                         "(set_generator(model, g))")
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Drop the whole residual branch per sample with probability ``rate``."""
    if not training or rate == 0.0:
        return x
    return _masked(x, rate, (x.shape[0],) + (1,) * (x.ndim - 1), generator,
                   "drop_path")


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Zero each element with probability ``p``."""
    if not training or p == 0.0:
        return x
    return _masked(x, p, x.shape, generator, "dropout")
