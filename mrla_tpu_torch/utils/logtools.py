"""Post-hoc log tooling: the port's copy of the JAX package's
``utils/logtools.py`` (pure Python; the port imports nothing of that
package).

Replaces the reference's resnet/best.py (best-epoch extraction + CSV),
deit/clearlog_best.py (JSONL best) and resnet/eval_visual.py (training
curves).  The port's trainers write the files these read:
``<metric>.txt`` with "epoch value" lines (``train/metrics.py:data_save``)
and ``log.txt`` with one JSON record an epoch (``jsonl_log``).

    python -m mrla_tpu_torch.utils.logtools <run_dir> [--csv out.csv]
        [--plot curves.png]
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional


def best_from_txt(path: str) -> Optional[dict]:
    """<name>.txt with 'epoch value' lines -> best epoch/value."""
    if not os.path.exists(path):
        return None
    best = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            epoch, val = int(parts[0]), float(parts[1])
            if best is None or val > best["value"]:
                best = {"epoch": epoch, "value": val}
    return best


def best_from_jsonl(path: str, key: str = "test_acc1") -> Optional[dict]:
    """deit-style log.txt (one JSON per line) -> best record by key."""
    if not os.path.exists(path):
        return None
    best = None
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if key in rec and (best is None or rec[key] > best[key]):
                best = rec
    return best


def txt_to_csv(run_dir: str, out_path: str, metrics=("train_loss", "val_acc1",
                                                     "val_acc5")) -> int:
    """Merge per-metric txt files into one CSV (epoch, metric...); returns rows."""
    series = {}
    for m in metrics:
        p = os.path.join(run_dir, f"{m}.txt")
        if os.path.exists(p):
            with open(p) as f:
                series[m] = {
                    int(p[0]): float(p[1])
                    for p in (l.split() for l in f)
                    if len(p) >= 2  # skip stray short lines, like best_from_txt
                }
    epochs = sorted(set().union(*[s.keys() for s in series.values()])) if series else []
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", *series.keys()])
        for e in epochs:
            w.writerow([e, *[series[m].get(e, "") for m in series]])
    return len(epochs)


def plot_curves(run_dir: str, out_path: str,
                metrics=("train_loss", "val_acc1", "val_acc5")) -> bool:
    """Training-curve PNG (resnet/eval_visual.py capability)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False

    fig, axes = plt.subplots(1, len(metrics), figsize=(5 * len(metrics), 4))
    if len(metrics) == 1:
        axes = [axes]
    plotted = False
    for ax, m in zip(axes, metrics):
        p = os.path.join(run_dir, f"{m}.txt")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            pts = [
                (int(p[0]), float(p[1]))
                for p in (l.split() for l in f)
                if len(p) >= 2
            ]
        if pts:
            xs, ys = zip(*sorted(pts))
            ax.plot(xs, ys)
            ax.set_title(m)
            ax.set_xlabel("epoch")
            plotted = True
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return plotted


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser("log tools")
    p.add_argument("run_dir")
    p.add_argument("--csv", default=None)
    p.add_argument("--plot", default=None, help="write training-curve PNG")
    args = p.parse_args()
    print("best val_acc1:", best_from_txt(os.path.join(args.run_dir, "val_acc1.txt")))
    print("best jsonl:", best_from_jsonl(os.path.join(args.run_dir, "log.txt")))
    if args.csv:
        n = txt_to_csv(args.run_dir, args.csv)
        print(f"wrote {n} epochs to {args.csv}")
    if args.plot:
        ok = plot_curves(args.run_dir, args.plot)
        print(f"plot {'written to ' + args.plot if ok else 'skipped'}")
