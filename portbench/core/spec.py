"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own under this folder, found by name:

    configs/<config>.json     the configuration (the ``file`` of its entry)
    traffic/<traffic>.json    a traffic mix: its ``kind`` names the
                              generator, ``loops/<kind>.py``
    metrics/<metric>.py       a per-layer metric's reader, ``read(window)``
    limits/<workload>.json    the cell's correctness limits
    systems/<family>.py       the port's entries for a configuration family
    reference/<family>.py     the family's plain reference

so a later change adds a cell, a mix or a metric by adding files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PKG = Path(__file__).resolve().parent.parent


def load_benchmark(root) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, bench: dict, workload: str, root, pkg: Path = PKG):
        self.bench, self.pkg = bench, Path(pkg)
        self.workload = _by_name(bench["workloads"], workload, "workload")
        self.name = workload
        entry = _by_name(bench["configs"], self.workload["config"], "config")
        self.config = _json(Path(root) / entry["file"])
        self.traffic = _json(self.pkg / "traffic"
                             / f"{self.workload['traffic']}.json")
        limits = self.pkg / "limits" / f"{workload}.json"
        self.limits: Dict[str, float] = (_json(limits)["limits"]
                                         if limits.exists() else {})
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports: those that list it,
        and those that list no cells."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def system(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.systems.{self.config['family']}")

    def loop(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.loops.{self.traffic['kind']}")

    def reader(self, metric: str) -> ModuleType:
        return load_reader(metric, self.pkg)


def load_reader(metric: str, pkg: Path = PKG) -> ModuleType:
    """The per-layer metric ``metric``'s reader module,
    ``metrics/<metric>.py`` (loaded by its path: the name may hold
    dots)."""
    path = Path(pkg) / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for the per-layer metric "
                                f"{metric!r}: {path}")
    mod_name = "portbench.metrics." + metric.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
