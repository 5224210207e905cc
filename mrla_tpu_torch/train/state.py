"""The train state: the model, its optimizer and schedule, the step, and
an optional EMA copy (the JAX package's ``train/state.py``).

The EMA decays EVERY floating ``state_dict`` entry, the BN running
statistics included, as timm's ``ModelEma`` (which the reference uses) and
the JAX package's ``ema_batch_stats`` do, so an EMA evaluation sees the
EMA's own statistics: e <- d·e + (1 - d)·live after each step.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from mrla_tpu_torch.nn.layers import DropPath, Dropout


@dataclass
class TrainState:
    """``ddp``: the module the step runs under data parallelism (DDP around
    ``model``); checkpoints and the EMA hold ``model`` itself."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    ema: Optional[nn.Module] = None
    ema_decay: float = 0.0
    ddp: Optional[nn.Module] = None


def _ema_pairs(state: TrainState) -> Tuple[List[torch.Tensor],
                                           List[torch.Tensor]]:
    live = state.model.state_dict()
    pairs = [(e, live[k]) for k, e in state.ema.state_dict().items()
             if e.is_floating_point()]
    return [e for e, _ in pairs], [p for _, p in pairs]


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       schedule: Callable[[int], float],
                       ema_decay: float = 0.0) -> TrainState:
    """A state at step 0; with ``ema_decay > 0`` the EMA starts as a copy
    of the model (eval mode, no gradients, no generators)."""
    ema = None
    if ema_decay > 0:
        drops = [m for m in model.modules()
                 if isinstance(m, (DropPath, Dropout))]
        gens = [m.generator for m in drops]
        for m in drops:  # a generator is the live model's alone
            m.generator = None
        ema = copy.deepcopy(model).eval().requires_grad_(False)
        for m, g in zip(drops, gens):
            m.generator = g
    return TrainState(model, optimizer, schedule, ema=ema,
                      ema_decay=ema_decay)


@torch.no_grad()
def update_ema(state: TrainState) -> None:
    """e <- d·e + (1 - d)·live over every floating state_dict entry."""
    ema, live = _ema_pairs(state)
    d = state.ema_decay
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, live, alpha=1.0 - d)
