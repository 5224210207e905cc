"""Metric meters and the reference's log artifacts (the port's copy of the
JAX package's ``train/metrics.py``).

  * ``AverageMeter`` and the per-epoch txt files (``data_save`` appends
    "epoch value" lines, one file per metric), the reference ResNet
    trainer's;
  * ``SmoothedValue`` and the JSON-lines log (``jsonl_log``: one object per
    epoch in log.txt), the reference DeiT trainer's.
"""

from __future__ import annotations

import json
import os
from collections import deque


class AverageMeter:
    """Running average (same contract as the reference's meter)."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        fmt = self.fmt[1:]
        return f"{self.name} {self.val:{fmt}} ({self.avg:{fmt}})"


class SmoothedValue:
    """Window-smoothed meter (the reference DeiT trainer's, minus the
    cross-rank sync)."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


def data_save(root: str, name: str, epoch: int, value: float) -> None:
    """Append 'epoch value' to <root>/<name>.txt (the reference's
    artifact format)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"{name}.txt"), "a") as f:
        f.write(f"{epoch} {value}\n")


def jsonl_log(path: str, record: dict) -> None:
    """Append one JSON object per line (deit log.txt format)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
