"""Readings that the correctness limits are set from (never part of a
benchmark run).

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        [--variant program|control|witness|fp32|answer|half_batch|unchanged] \\
        [--seconds 2] [--out <file.jsonl>]

Runs the cell once a seed in one process (``run.run_cell``, no look for
a card) and prints a JSON line a seed with every compared number.
``program`` is the port as the cell runs it; ``control`` puts the
lower-precision control in its place (the system module's ``control``
for serving, the reference in float8 for training); two witnesses of
what the training cells' precision alone reads: ``witness``, the
reference in bfloat16 in the trainer's place, and ``fp32``, the port's
trainer itself with bf16 autocast and TF32 off; the others break the
timed path underneath, in the port's entry (``FAULTS``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib
import json
import sys

import torch

from portbench import run as bench
from portbench.core import spec
from portbench.loops import train_steps
from portbench.reference.common import Precision


def _patched(module: str, name: str, wrap):
    @contextlib.contextmanager
    def cm():
        mod = importlib.import_module(module)
        orig = getattr(mod, name)
        setattr(mod, name, wrap(orig))
        try:
            yield
        finally:
            setattr(mod, name, orig)
    return cm()


def _answer(fn):
    """One answer altered where it is produced: the first image's logits
    reversed."""
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        out[0] = out[0].flip(0)
        return out
    return wrapped


def _half_serve(fn):
    """Half of the batch left out: the engine runs the first half, whose
    answers stand in for the second's."""
    def wrapped(params, x, *a, **k):
        out = fn(params, x[:x.shape[0] // 2], *a, **k)
        return torch.cat([out, out])
    return wrapped


def _half_train(fn):
    """Half of the batch left out, the loss the mean over the rest."""
    def wrapped(state, batch, *a, **k):
        half = batch["image"].shape[0] // 2
        return fn(state, {key: v[:half] for key, v in batch.items()}, *a,
                  **k)
    return wrapped


def _unchanged(fn):
    """A step that returns its state unchanged: the model's parameters and
    buffers, and the EMA, put back after it."""
    def wrapped(state, *a, **k):
        held = [m for m in (state.model, state.ema) if m is not None]
        saved = [copy.deepcopy(m.state_dict()) for m in held]
        out = fn(state, *a, **k)
        for m, sd in zip(held, saved):
            m.load_state_dict(sd)
        return out
    return wrapped


STEP = ("mrla_tpu_torch.train.steps", "train_step")
# fault -> (traffic kind -> wrapper of the entry)
FAULTS = {
    "answer": {"serve_closed_loop": _answer},
    "half_batch": {"serve_closed_loop": _half_serve,
                   "train_steps": _half_train},
    "unchanged": {"train_steps": _unchanged},
}


def fault(cell: spec.Cell, name: str):
    """The context in which the cell's timed path carries fault ``name``."""
    kind = cell.traffic["kind"]
    wrap = FAULTS[name][kind]
    entry = STEP if kind == "train_steps" else cell.system().ENTRY
    return _patched(*entry, wrap)


class ReferenceTrainer:
    """The reference, in the precision ``q``, in the port's trainer's
    place (``train_steps.TRAINER``)."""

    def __init__(self, run, sd: dict, q: Precision):
        self.steps = train_steps.reference_steps(run, sd, q)

    def step(self, i: int, images, labels) -> dict:
        return {"loss": self.steps.step(images, labels)}

    def first_grads(self) -> dict:
        return {n: g.cpu() for n, g in self.steps.first.items()}

    def changes(self) -> dict:
        got = self.steps.result()
        return {key: {n: t.cpu() for n, t in got[key].items()}
                for key in ("change", "stat_change", "ema_change")
                if key in got}


def _program_fp32(run, sd: dict):
    """The port's trainer with bf16 autocast and TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.traffic = {**run.traffic,
                   "recipe": {**run.traffic["recipe"], "bf16": False}}
    return train_steps.ProgramTrainer(run, sd)


TRAINERS = {
    "control": lambda run, sd: ReferenceTrainer(run, sd, Precision(fp8=True)),
    "witness": lambda run, sd: ReferenceTrainer(run, sd,
                                                Precision(bf16=True)),
    "fp32": _program_fp32,
}


def replaced(cell: spec.Cell, variant: str):
    """The context in which ``variant`` takes the program's place."""
    if cell.traffic["kind"] == "train_steps":
        trainer = TRAINERS[variant]
        return _patched("portbench.loops.train_steps", "TRAINER",
                        lambda orig: trainer)
    if variant != "control":
        raise ValueError(f"no {variant!r} for a serving cell")
    system = cell.system()
    return _patched(system.__name__, "serving", lambda orig: system.control)


def readings(workload: str, seed: int, seconds: float, variant: str,
             device="cuda", root=bench.ROOT, pkg=spec.PKG) -> dict:
    """One run's result, with ``variant`` as the module docstring says."""
    cell = spec.Cell(spec.load_benchmark(root), workload, root, pkg)
    if variant in FAULTS:
        ctx = fault(cell, variant)
    elif variant == "program":
        ctx = contextlib.nullcontext()
    else:
        ctx = replaced(cell, variant)
    with ctx:
        return bench.run_cell(workload, seed, seconds, False, device, root,
                              pkg=pkg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="program")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    bench.set_environment()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = readings(args.workload, seed, args.seconds, args.variant)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "variant": args.variant,
                               "correct": res["correct"],
                               "readings": res["_readings"],
                               "memory_peak_bytes":
                                   res["device"]["memory_peak_bytes"],
                               "notes": res["_notes"]}, default=str)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
