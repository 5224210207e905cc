"""The yardstick's arithmetic: the kernel table's bounds at its shapes,
and the model FLOPs against FlopCounterMode over the reference."""

from __future__ import annotations

import importlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import deit_mrlal, init, resnet_mrlal
from portbench.tests.conftest import PKG
from portbench.work import peaks, tails


@pytest.mark.parametrize("work, want_ms", [
    (tails.epilogue(128, 14, 14, 1024), 0.0462),
    (tails.epilogue(128, 7, 7, 2048), 0.0233),
    (tails.megatail(128, 56, 56, 256, 64), 0.1994),
    (tails.megatail(128, 56, 56, 256, 128), 0.2148),
    (tails.megatail(128, 28, 28, 512, 128), 0.0998),
    (tails.token_tail(128, 197, 384, 5), 0.0173),
    (tails.token_tail(128, 577, 768, 7), 0.1016),
], ids=["epilogue_s3", "epilogue_s4", "megatail_c64", "megatail_c128",
        "megatail_s2", "token_tail", "token_tail_base384"])
def test_bounds_reproduce_the_kernel_table(work, want_ms):
    assert round(peaks.bound_s(*work) * 1e3, 4) == want_ms


def test_bound_takes_the_slowest_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 989e12, 67e12) == pytest.approx(2.0)


def _config(name, **small):
    cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
    cfg.update(small)
    return cfg


def _flops(cfg):
    """The forward FLOPs an image that the family's system module names."""
    system = importlib.import_module(f"portbench.systems.{cfg['family']}")
    return system.flops_per_image(cfg)


@pytest.mark.parametrize("name, small", [
    ("resnet50_mrlal", {"layers": [1, 2, 1, 1], "image_size": 64,
                        "num_classes": 10}),
    ("deit_mrlal_small_patch16_224", {"depth": 2, "image_size": 48,
                                      "num_classes": 10}),
])
def test_flops_count_what_flop_counter_mode_counts(name, small):
    cfg = _config(name, **small)
    family = resnet_mrlal if cfg["family"] == "resnet_mrlal" else deit_mrlal
    sd = init.draw(family.spec(cfg), torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, cfg["image_size"], cfg["image_size"], 3)
    with FlopCounterMode(display=False) as fc:
        family.forward(sd, cfg, x)
    assert fc.get_total_flops() == 2 * _flops(cfg)


def test_published_flops():
    assert _flops(_config("resnet50_mrlal")) == pytest.approx(
        8.278e9, rel=1e-3)
    assert _flops(_config("deit_mrlal_small_patch16_224")) == \
        pytest.approx(9.214e9, rel=1e-3)
