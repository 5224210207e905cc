"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` there).  Set-up builds the
port's kernel library on the first run of a checkout (into the port's own
``mrla_tpu_torch/_build/<digest>/``) and loads it after, makes the weights
on the card from the seed, builds the cell's entry and warms up every
shape the window uses; then the window runs for ``--seconds``.  After it,
the peak memory is read, the program's state freed, and what the window
produced is compared with the plain reference (``core/checks.py``; the
limits in ``limits/<workload>.json``).

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the window runs under the device profiler and
the metrics are the cell's per-layer metrics, each from its reader
``metrics/<name>.py``.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
traced also ``breakdown``, and last ``checks``: each compared number with
its limit); the compared numbers are also the last lines of standard
error.  Without a card, or with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it prints
no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from portbench.core import clock

START = clock.process_start()
ROOT = Path.cwd()
THREADS = 4  # the host's work is launching: few threads, steadier runs

import torch  # noqa: E402  (after the start time is read)

from portbench.core import checks, guard, spec, trace  # noqa: E402
from portbench.reference import init  # noqa: E402


class NoCard(RuntimeError):
    pass


class Run:
    """One run of a cell: what the loops and readers share."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace_on: bool, device):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.cfg, self.traffic = cell.config, cell.traffic
        self.system = cell.system()
        self.device = torch.device(device)
        self.spans = clock.Spans(trace_on)
        self.window = trace.Window(trace_on)
        self.window.spans = self.spans.spans
        self.window.cell = cell
        self.window.flops_per_image = self.system.flops_per_image(self.cfg)
        self.memory_peak = 0
        self.notes: dict = {}
        cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if cuda else None
        self.window.side_stream = self._side

    def weights(self) -> dict:
        """The configuration's weights from the seed, on the device: drawn
        in a few calls, then (ResNet) every BN's statistics set by one
        batch of seeded images through the reference."""
        gen = init.seeded(self.seed, 0, device=self.device)
        family = self.system.reference
        sd = init.draw(family.spec(self.cfg), gen, self.device)
        family.calibrate(sd, self.cfg, init.images(
            gen, 16, self.cfg["image_size"], self.device))
        return sd

    def on_side_stream(self, make):
        """``make()`` run on the benchmark's own stream; the current stream
        waits for it.  A tensor or a tuple of tensors."""
        if self._side is None:
            return make()
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = make()
        main.wait_stream(self._side)
        for t in (out if isinstance(out, tuple) else (out,)):
            t.record_stream(main)
        return out

    def stamp(self, what: str) -> None:
        """Note the seconds since the process started (set-up's parts)."""
        self.notes[f"t.{what}"] = time.time() - START

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def free_program(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def note(self, extra: dict) -> None:
        self.notes.update(extra)


def check_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures on a card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} present")


def set_environment() -> None:
    torch.set_num_threads(THREADS)


def apply_tf32(cfg: dict) -> None:
    """The configuration's stated TF32 settings (the trainer's, which are
    PyTorch's defaults)."""
    tf32 = cfg.get("tf32", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32.get("matmul", False))
    torch.backends.cudnn.allow_tf32 = bool(tf32.get("cudnn", True))


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool,
             device="cuda", root=ROOT, pkg=spec.PKG) -> dict:
    """Run the cell once (no look for a card here) and return the result
    line's object (``calibrate.py`` and the tests call it with the timed
    path replaced or broken underneath)."""
    cell = spec.Cell(spec.load_benchmark(root), workload, root, pkg)
    apply_tf32(cell.config)
    run = Run(cell, seed, seconds, trace_on, device)
    run.stamp("imported")
    measured = cell.loop().run(run)
    win = run.window
    correct, compared = checks.decide(measured["values"], cell.limits)
    result = {"correct": correct, "attempted": measured["attempted"],
              "failed": measured["failed"]}
    setup_s = win.ns0 / 1e9 - START
    if trace_on:
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(measured["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    result["metrics"] = metrics
    dev = run.device
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips, "memory_peak_bytes": run.memory_peak}
    if trace_on:
        result["device"]["busy_s"] = win.busy_seconds()
        result["device"]["window_s"] = win.seconds
        result["breakdown"] = win.breakdown()
    result["checks"] = compared
    result["_readings"] = dict(measured["values"], setup_s=setup_s,
                               **{f"e2e.{k}": v
                                  for k, v in measured["e2e"].items()})
    result["_notes"] = run.notes
    return result


def check_lines(compared: dict) -> list:
    return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
            for n, c in compared.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    try:
        check_card(cell.chips)
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = guard.loaded_banned()
    if found:
        print(f"portbench: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 4
    print("portbench: notes " + json.dumps(result.pop("_notes"),
                                           default=str), file=sys.stderr)
    print("portbench: readings " + json.dumps(result.pop("_readings")),
          file=sys.stderr)
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
