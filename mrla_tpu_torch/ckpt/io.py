"""Training checkpoints with ``torch.save`` (the counterpart of the JAX
package's ``ckpt/orbax_io.py``): the reference's logical content.

One file holds the model's, the optimizer's and the EMA's state_dicts,
the step, the just-completed epoch and the best acc@1.  Every epoch
overwrites ``<dir>/checkpoint.pt``; ``best.pt`` is written when the epoch
is the best so far and ``epoch_<e>.pt`` every ``keep_every``-th epoch.  A
resumed run continues at the epoch after the stored one.
``read_model_state_dict`` reads the model's state_dict alone, without
loading it anywhere: ``--finetune`` edits it before it loads it, and
``--teacher-resume`` loads it into a teacher.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from mrla_tpu_torch.train.state import TrainState


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    best_acc1: float = 0.0, is_best: bool = False,
                    keep_every: int = 0) -> None:
    ckpt = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": None if state.ema is None else state.ema.state_dict(),
        "step": state.step,
        "epoch": epoch,
        "best_acc1": float(best_acc1),
    }
    os.makedirs(directory, exist_ok=True)
    names = ["checkpoint"]
    if is_best:
        names.append("best")
    if keep_every and epoch % keep_every == 0:
        names.append(f"epoch_{epoch}")
    for name in names:
        path = os.path.join(directory, f"{name}.pt")
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)  # never a half-written checkpoint


def restore_checkpoint(directory: str, state: TrainState,
                       name: str = "checkpoint"
                       ) -> Optional[Tuple[TrainState, int, float]]:
    """Load ``<directory>/<name>.pt`` into ``state`` (in place, onto its
    model's device); returns (state, epoch, best_acc1), or None if there
    is no such file."""
    path = os.path.join(directory, f"{name}.pt")
    if not os.path.exists(path):
        return None
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.ema is not None and ckpt["ema"] is not None:
        state.ema.load_state_dict(ckpt["ema"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"]), float(ckpt["best_acc1"])


def read_model_state_dict(directory: str, name: str = "checkpoint",
                          map_location="cpu"
                          ) -> Optional[Dict[str, torch.Tensor]]:
    """The model state_dict of ``<directory>/<name>.pt``, or None if
    there is no such file."""
    path = os.path.join(directory, f"{name}.pt")
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=map_location,
                      weights_only=True)["model"]
