"""A tiny copy of the benchmark for CPU tests: the same cells, files and
limits, at widths as published but a small depth (ResNet 1-1-1-1), small
images, ten classes and small batches."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
TINY_CONFIG = {"resnet_mrlal": {"layers": [1, 1, 1, 1], "image_size": 64,
                                "num_classes": 10},
               "deit_mrlal": {"image_size": 48, "num_classes": 10}}
TINY_BATCH = 8


def make_tiny(root: Path) -> tuple:
    """(root, pkg) of a tiny benchmark under ``root``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "cfg").mkdir(parents=True)
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg.update(TINY_CONFIG[cfg["family"]])
        entry["file"] = f"cfg/{entry['name']}.json"
        (root / entry["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = root / "pkg"
    shutil.copytree(PKG / "metrics", pkg / "metrics")
    shutil.copytree(PKG / "limits", pkg / "limits")
    (pkg / "traffic").mkdir()
    for path in (PKG / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["batch"] = TINY_BATCH
        if "check_images" in t:
            t["check_images"] = 2 * TINY_BATCH
        (pkg / "traffic" / path.name).write_text(json.dumps(t))
    return root, pkg


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(4)
    return make_tiny(tmp_path)
