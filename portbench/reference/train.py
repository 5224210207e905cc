"""The reference's first training steps, for any family module that has
``train_loss`` and ``decayed``: float32, TF32 off, its own optimizer and
schedule (``common``), on the batches and stochastic-depth generator the
benchmark hands it.

``Steps`` takes one step at a time; ``result`` gives what the comparison
reads: each step's loss, every leaf's first gradient, every leaf's change
over the steps, and the change of every BN running statistic and, with
the recipe's ``ema_decay``, of the EMA over the steps.  The EMA is kept
as the configuration's trainer states it: every floating entry,
e <- d e + (1 - d) live after each step, in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.reference import common
from portbench.reference.common import FP32, Precision

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
STATS = BUFFERS[:2]


def trainable(sd: Dict[str, torch.Tensor]) -> List[str]:
    """The state dict's parameters: every entry but BN's statistics."""
    return [n for n in sd if not n.endswith(BUFFERS)]


class Steps:
    """The reference's training state on the weights ``sd`` (left
    unchanged); ``mix_rng(i)`` is step i's Mixup / CutMix generator."""

    def __init__(self, family, sd: Dict[str, torch.Tensor], cfg: dict,
                 recipe: dict, mix_rng: Callable[[int], object],
                 drop_gen: torch.Generator, start_step: int,
                 steps_per_epoch: int, q: Precision = FP32):
        self.family, self.cfg, self.recipe, self.q = family, cfg, recipe, q
        self.mix_rng, self.drop_gen = mix_rng, drop_gen
        self.start_step, self.spe = start_step, steps_per_epoch
        names = trainable(sd)
        self.params = {n: sd[n].detach().clone().float().requires_grad_(True)
                       for n in names}
        self.stats = {n: sd[n].detach().clone() for n in sd
                      if n.endswith(STATS)}
        self.sd = {**sd, **self.stats}
        self.start = {n: t.detach().clone() for n, t in
                      {**self.params, **self.stats}.items()}
        self.decay = recipe.get("ema_decay", 0.0)
        self.ema = ({n: t.clone() for n, t in self.start.items()}
                    if self.decay > 0 else None)
        if recipe["opt"] == "sgd":
            self.opt = common.SGD(self.params, recipe["momentum"],
                                  recipe["weight_decay"])
        elif recipe["opt"] == "adamw":
            decay = {n for n, p in self.params.items()
                     if family.decayed(n, p)}
            self.opt = common.AdamW(self.params, decay,
                                    recipe["weight_decay"])
        else:
            raise ValueError(f"no reference for optimizer {recipe['opt']!r}")
        self.losses: List[float] = []
        self.first = None
        self.i = 0

    def step(self, images: torch.Tensor, labels: torch.Tensor) -> float:
        """One step on (images NHWC fp32, labels int64); its loss."""
        recipe, classes, i = self.recipe, self.cfg["num_classes"], self.i
        with common.exact_fp32():
            if recipe.get("mixup", 0) > 0 or recipe.get("cutmix", 0) > 0:
                images, targets = common.mixup_cutmix(
                    self.mix_rng(i), images, labels, classes,
                    max(recipe.get("mixup", 0.0), 1e-8),
                    max(recipe.get("cutmix", 0.0), 1e-8),
                    recipe.get("label_smooth", 0.0))
            else:
                targets = common.label_smoothing_targets(
                    labels, classes, recipe.get("label_smooth", 0.0))
            loss = self.family.train_loss(self.params, self.sd, self.cfg,
                                          images, targets, self.drop_gen,
                                          recipe, self.q)
            grads = dict(zip(self.params, torch.autograd.grad(
                loss, list(self.params.values()))))
            if self.first is None:
                self.first = {n: g.detach().clone() for n, g in grads.items()}
            self.opt.step(grads, common.learning_rate(
                recipe, self.start_step + i, self.spe))
            if self.ema is not None:
                live = {**self.params, **self.stats}
                with torch.no_grad():
                    for n, e in self.ema.items():
                        e.mul_(self.decay).add_(live[n].detach(),
                                                alpha=1.0 - self.decay)
        self.losses.append(float(loss.detach()))
        self.i += 1
        return self.losses[-1]

    def result(self) -> dict:
        out = {"losses": np.array(self.losses), "first_grad": self.first,
               "change": {n: p.detach() - self.start[n]
                          for n, p in self.params.items()},
               "stat_change": {n: t - self.start[n]
                               for n, t in self.stats.items()}}
        if self.ema is not None:
            out["ema_change"] = {n: e - self.start[n]
                                 for n, e in self.ema.items()}
        return out

