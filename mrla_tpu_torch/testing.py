"""Seeded stand-ins for a trained model and real images, for smoke runs and
profiles of the serving path (``chip_smoke.py``, ``profile_serving.py``).

Random weights alone make a poor serving check: with freshly initialised BN
statistics and pure-noise images, every image gives almost the same logits.
So bn3 gets a non-zero scale (it is zero-initialised, which would leave
every residual branch idle), the BN statistics are set from a pass over
seeded images, and the images are smooth colour fields with their own
contrast and colour cast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mrla_tpu_torch.models import create_model


def images(gen: torch.Generator, n: int, px: int = 224) -> torch.Tensor:
    """n seeded NHWC fp32 images on the CPU: smooth random colour fields
    plus pixel noise, each with its own contrast and colour cast, so that
    images differ after the global pool as real ones do."""
    lo = torch.randn(n, 3, 7, 7, generator=gen)
    x = F.interpolate(lo, size=px, mode="bilinear", align_corners=False)
    x = x + 0.3 * torch.randn(n, 3, px, px, generator=gen)
    x = x * (0.5 + 2.5 * torch.rand(n, 1, 1, 1, generator=gen))
    x = x + torch.randn(n, 3, 1, 1, generator=gen)
    return x.permute(0, 2, 3, 1).contiguous()


def serving_model(seed: int) -> torch.nn.Module:
    """resnet50_mrlal on the CPU from ``seed``, in eval mode, with bn3
    scales drawn from U(0.1, 0.5) and the BN statistics averaged over a
    pass of 16 seeded 224 px images."""
    gen = torch.Generator().manual_seed(seed)
    model = create_model("resnet50_mrlal", device="cpu", generator=gen)
    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for name, bn in bns:
            if name.endswith("bn3"):
                bn.weight.uniform_(0.1, 0.5, generator=gen)
            bn.reset_running_stats()
            bn.momentum = None  # cumulative average over the calibration
        model.train()(images(gen, 16))
    for _, bn in bns:
        bn.momentum = 0.1
    return model.eval()
