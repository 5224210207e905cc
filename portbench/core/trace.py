"""The measured window and, in a traced run, what the device did in it.

A traced run profiles device activity only (``torch.profiler`` with the
CUDA activity: kernels, copies and memsets from CUPTI), never the host's
torch ops, so the host keeps its pace; the host spans are the
benchmark's own few (``clock.Spans``).  Both are stamped on the same
clock, ``time.time_ns``.

The port's launch counters (``LaunchCounter`` on each kernel wrapper,
by shape) are read as the difference over the window.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

from portbench.work import names

Event = Tuple[str, int, int, int]  # name, start ns, end ns, stream
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, on the side stream


def span_union_ns(spans) -> int:
    """The length of the union of (start, end) spans: overlaps count
    once (the arithmetic of the program's ``profile_serving.span_union``,
    copied)."""
    total, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def merged(spans) -> List[Tuple[int, int]]:
    """The union of spans as disjoint sorted intervals."""
    out: List[List[int]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def launch_counters() -> Dict[str, collections.Counter]:
    """Every launch counter of the port loaded in this process, by
    ``module.function``: a copy of its launches by shape."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("mrla_tpu_torch.") or mod is None:
            continue
        for attr, obj in list(vars(mod).items()):
            counter = getattr(obj, "counter", None)
            if hasattr(counter, "by_shape"):
                out[f"{mod_name}.{attr}"] = collections.Counter(
                    counter.by_shape)
    return out


class Window:
    """The measured window: its clocks, the work the loop did in it and,
    traced, the device's events and the port's launches.  Readers of
    per-layer metrics get this object."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.t0 = self.t1 = None        # perf_counter seconds
        self.ns0 = self.ns1 = None      # time.time_ns
        self.units = 0                  # forwards or steps completed
        self.images = 0                 # images completed
        self.flops_per_image = 0.0      # the model's forward FLOPs
        self.events: List[Event] = []   # device activity in the window
        self.side_stream = None         # the benchmark's own stream
        self.side_ids: set = set()      # its id in the trace
        self.launches: Dict[str, collections.Counter] = {}
        self.spans: List[Event] = []
        self.cell = None
        self._prof = None
        self._counters0 = None

    # the loop's calls -------------------------------------------------
    def begin(self) -> None:
        if self.trace:
            self._counters0 = launch_counters()
            # device activity only; a CPU run (the tests) has none, and
            # profiles the host instead so that the path still runs
            act = torch.profiler.ProfilerActivity
            self._prof = torch.profiler.profile(activities=[
                act.CUDA if self.side_stream is not None else act.CPU])
            self._prof.__enter__()
            if self.side_stream is not None:
                with torch.cuda.stream(self.side_stream):
                    torch.cuda._sleep(1)
        self.ns0 = time.time_ns()
        self.t0 = time.perf_counter()

    def end(self) -> None:
        """Call once the window's work is done and synchronised."""
        self.t1 = time.perf_counter()
        self.ns1 = time.time_ns()
        if self.trace:
            self._prof.__exit__(None, None, None)
            self.events = device_events(self._prof)
            self.side_ids = {e[3] for e in self.events if MARKER in e[0]}
            self._prof = None
            after = launch_counters()
            self.launches = {k: after[k] - self._counters0.get(
                k, collections.Counter()) for k in after}

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    # what readers use -------------------------------------------------
    def kernels(self, pred: Callable[[str], bool] = names.is_kernel
                ) -> List[Event]:
        """The program's kernels whose name ``pred`` takes: the
        benchmark's own stream (its input draws) left out."""
        return [e for e in self.events if e[3] not in self.side_ids
                and names.is_kernel(e[0]) and pred(e[0])]

    def kernel_seconds(self, pred: Callable[[str], bool]) -> float:
        """The summed device time of the kernels whose name ``pred``
        takes."""
        return sum(e - s for _, s, e, _ in self.kernels(pred)) / 1e9

    def union_seconds(self, pred: Callable[[str], bool]) -> float:
        """The device time of those kernels with overlaps counted once."""
        return span_union_ns((s, e) for _, s, e, _ in self.kernels(pred)
                             ) / 1e9

    def busy_seconds(self) -> float:
        """The union of every device span in the window."""
        return span_union_ns(self._clipped()) / 1e9

    def counter(self, qualified: str) -> collections.Counter:
        """The launches by shape of the port's wrapper ``qualified``
        (``module.function``) in the window; empty if it never ran."""
        return self.launches.get(qualified, collections.Counter())

    def _clipped(self):
        return [(max(s, self.ns0), min(e, self.ns1)) for _, s, e, _ in
                self.events if e > self.ns0 and s < self.ns1]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the host span it began in."""
        by_name = collections.Counter()
        for n, s, e, _ in self.events:
            by_name[short(n)] += (e - s) / 1e9
        busy = merged(self._clipped())
        edges = [self.ns0] + [x for iv in busy for x in iv] + [self.ns1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, t] for n, t in by_name.most_common(top)],
                "idle_gaps": [[self.host_at(a), (b - a) / 1e9]
                              for a, b in gaps[:top]]}

    def host_at(self, ns: int) -> str:
        """What the host was doing at ``ns``: the innermost benchmark span
        that holds it, else "after <the last span that ended before>"."""
        holding = [sp for sp in self.spans if sp[1] <= ns < sp[2]]
        if holding:
            return max(holding, key=lambda sp: sp[1])[0]
        before = [sp for sp in self.spans if sp[2] <= ns]
        if before:
            return "after " + max(before, key=lambda sp: sp[2])[0]
        return "before the first span"


def short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def device_events(prof) -> List[Event]:
    """(name, start ns, end ns, stream) of every device activity in a
    finished profile, from the profiler's raw results (no per-op
    post-processing, which would take minutes over a window's events)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(),
                    e.device_resource_id()))
    return out
