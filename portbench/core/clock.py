"""Clocks: when the process started, and the host spans the benchmark
records around its own calls (in the profiler's clock, ``time.time_ns``)."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import List, Tuple

_IMPORTED = time.time()


def process_start() -> float:
    """The process's start as a ``time.time()``, from the kernel's record
    of it (``/proc/self/stat`` and the boot time); the import of this
    module where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


class Spans:
    """Host spans (name, start ns, end ns) kept in memory; recorded only
    when ``enabled`` (the traced run)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: List[Tuple[str, int, int]] = []

    @contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))
