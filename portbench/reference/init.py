"""The benchmark's seeded weights: every leaf of a state dict drawn on the
device in a few large calls, whatever the number of leaves.

A spec is a list of ``(name, shape, rule)``; a rule is one of

    ("normal", mean, std)      N(mean, std)
    ("trunc", 0, std)          N(0, std) clamped to two std
    ("uniform", lo, hi)        U(lo, hi)
    ("const", value, 0)        every element ``value``
    ("count", 0, 0)            an int64 zero (BatchNorm's batch counter)

``draw`` makes one normal and one uniform draw over all float leaves
together from a generator on the device, and one affine per element
chosen by the leaf's rule, then splits the flat tensor into the leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, tuple, tuple]]
_KINDS = {"normal": 0, "trunc": 1, "uniform": 2, "const": 3}


def draw(spec: Spec, gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """The leaves of ``spec`` as fp32 tensors (int64 for "count") on
    ``device``, drawn from ``gen`` (a generator on that device)."""
    floats = [(n, s, r) for n, s, r in spec if r[0] != "count"]
    sizes = [math.prod(s) for _, s, _ in floats]
    total = sum(sizes)
    counts = torch.tensor(sizes, device=device)
    per_leaf = torch.tensor([[_KINDS[r[0]], r[1], r[2]] for _, _, r in floats],
                            dtype=torch.float64, device=device)
    kind, a, b = per_leaf.repeat_interleave(counts, dim=0, output_size=total
                                            ).float().unbind(1)
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    flat = torch.where(kind == 0, a + b * z,
           torch.where(kind == 1, a + b * z.clamp(-2.0, 2.0),
           torch.where(kind == 2, a + (b - a) * u, a)))
    out = {n: leaf.view(s) for (n, s, _), leaf in
           zip(floats, flat.split(sizes))}
    for n, s, r in spec:
        if r[0] == "count":
            out[n] = torch.zeros(s, dtype=torch.int64, device=device)
    return {n: out[n] for n, _, _ in spec}


def kaiming_fan_out(shape: tuple) -> tuple:
    """N(0, sqrt(2 / (out channels * kernel area)))."""
    fan_out = shape[0] * math.prod(shape[2:])
    return ("normal", 0.0, math.sqrt(2.0 / fan_out))


def batch_norm(prefix: str, c: int, scale: tuple, bias_std: float) -> Spec:
    """A BatchNorm's leaves: its scale by ``scale``, its bias N(0,
    bias_std), the statistics at 0 and 1 until a calibration pass sets
    them."""
    return [(f"{prefix}.weight", (c,), scale),
            (f"{prefix}.bias", (c,), ("normal", 0.0, bias_std)),
            (f"{prefix}.running_mean", (c,), ("const", 0.0, 0.0)),
            (f"{prefix}.running_var", (c,), ("const", 1.0, 0.0)),
            (f"{prefix}.num_batches_tracked", (), ("count", 0, 0))]


def images(gen: torch.Generator, n: int, px: int, device) -> torch.Tensor:
    """n NHWC fp32 images [n, px, px, 3] on the device: smooth random
    colour fields (7 x 7 noise resampled bilinearly) plus pixel noise,
    each with its own contrast and colour cast, so that images differ
    after a global pool as real ones do."""
    lo = torch.randn(n, 3, 7, 7, generator=gen, device=device)
    x = torch.nn.functional.interpolate(lo, size=(px, px), mode="bilinear",
                                        align_corners=False)
    x = x + 0.3 * torch.randn(n, 3, px, px, generator=gen, device=device)
    x = x * (0.5 + 2.5 * torch.rand(n, 1, 1, 1, generator=gen,
                                    device=device))
    x = x + torch.randn(n, 3, 1, 1, generator=gen, device=device)
    return x.permute(0, 2, 3, 1).contiguous()


def seeded(seed: int, *salt: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``salt``: the
    same numbers give the same stream, different ones unrelated streams."""
    mixed = seed & (2 ** 64 - 1)
    for s in salt:
        mixed = (mixed * 6364136223846793005 + 1442695040888963407 + s) \
            & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)
