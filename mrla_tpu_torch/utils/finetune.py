"""Fine-tuning surgery (the reference's deit/main.py ``--finetune``), the
port's counterpart of the JAX package's ``utils/finetune.py``:

  * the position embedding resampled bicubically when the token grid
    changes;
  * fresh classification heads for a new class count.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch


def torch_bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] resampling matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)``: cubic convolution with A = -0.75, taps past the
    edge clamped onto it."""
    a = -0.75

    def kern(x: float) -> float:
        ax = abs(x)
        if ax <= 1.0:
            return ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
        if ax < 2.0:
            return a * (((ax - 5.0) * ax + 8.0) * ax - 4.0)
        return 0.0

    w = np.zeros((n_out, n_in))
    scale = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            w[i, min(max(x0 + k, 0), n_in - 1)] += kern(x - (x0 + k))
    return w


def interpolate_pos_embed(pos_embed: torch.Tensor, new_num_patches: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """[1, old_n + extra, C] -> [1, new_num_patches + extra, C]: the square
    patch grid resampled by the bicubic matrix along rows, then columns
    (two fp32 contractions, as the JAX function computes them); the extra
    tokens (cls, and dist with a distilled model) kept."""
    extra = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:]
    old_n, c = grid.shape[1], grid.shape[2]
    old_s, new_s = math.isqrt(old_n), math.isqrt(new_num_patches)
    if old_s * old_s != old_n or new_s * new_s != new_num_patches:
        raise ValueError(f"grids of {old_n} and {new_num_patches} patches "
                         "are not both square")
    if new_s == old_s:
        return pos_embed
    g = grid.reshape(old_s, old_s, c).float()
    w = torch.as_tensor(torch_bicubic_weights(old_s, new_s),
                        dtype=torch.float32, device=g.device)
    g = torch.einsum("oi,ijc->ojc", w, g)  # rows
    g = torch.einsum("oj,ijc->ioc", w, g)  # columns
    g = g.reshape(1, new_s * new_s, c).to(pos_embed.dtype)
    return torch.cat([extra, g], dim=1)


def reset_classifier(state_dict: Dict[str, torch.Tensor], num_classes: int,
                     generator: torch.Generator,
                     head_names: Sequence[str] = ("head", "head_dist")
                     ) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with fresh heads for ``num_classes``:
    weights 0.02 · a normal truncated at ±2 in unit space (std about
    0.0176; the JAX package's convention), drawn from ``generator`` head
    by head, and zero biases.  The reference keeps its model's fresh head
    for a new class count, which is such a draw too."""
    out = dict(state_dict)
    for name in head_names:
        weight = state_dict.get(f"{name}.weight")
        if weight is None:
            continue
        fresh = torch.empty(num_classes, weight.shape[1], dtype=torch.float32)
        torch.nn.init.trunc_normal_(fresh, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        out[f"{name}.weight"] = (fresh * 0.02).to(weight.dtype).to(
            weight.device)
        out[f"{name}.bias"] = torch.zeros(num_classes, dtype=weight.dtype,
                                          device=weight.device)
    return out
