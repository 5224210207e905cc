"""Optimizers with the JAX package's semantics (``train/optim.py``).  Each
takes the learning rate of its first step; ``train/steps.py`` sets every
group's ``lr`` from the schedule before each step.

  * sgd_torch: ``torch.optim.SGD`` with the weight decay coupled into the
    gradient before the momentum buffer (optax's ``add_decayed_weights``
    then ``trace``), every parameter decayed.
  * adamw_timm: ``torch.optim.AdamW`` with two groups, the timm no-decay
    convention in the second (``decays``).
  * rmsprop_tf: TF1-style RMSprop (timm's RMSpropTF, the EfficientNet
    recipe): the square average starts at ONES, eps is added INSIDE the
    sqrt, weight decay is coupled into the gradient.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch
from torch import nn

# leaves the timm convention never decays, whatever their rank
_NO_DECAY_NAMES = ("pos_embed", "cls_token", "dist_token")
# the port's (the reference's) shapes of leaves the JAX package holds 1-D:
# the MRLA channel convs' [1, 1, k] and the resnet λ's [C, 1, 1]
_JAX_VECTORS = ("Wq.weight", "Wk.weight", "lambda_t")


def decays(name: str, p: torch.Tensor) -> bool:
    """The timm no-decay rule as the JAX package states it on its own
    shapes (``no_decay_mask``: rank >= 2, not a token nor the position
    embedding), applied to the port's parameter ``name``: biases, norm
    scales, λ, the MRLA Q / K taps and the tokens are not decayed."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _NO_DECAY_NAMES or name.endswith(_JAX_VECTORS):
        return False
    return p.ndim >= 2


def decay_groups(model: nn.Module) -> Tuple[List[str], List[str]]:
    """(names decayed, names not decayed) of ``model``'s trainable
    parameters."""
    yes, no = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (yes if decays(name, p) else no).append(name)
    return yes, no


def sgd_torch(params: Iterable, lr: float, momentum: float = 0.9,
              weight_decay: float = 0.0,
              nesterov: bool = False) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay, nesterov=nesterov)


def adamw_timm(model: nn.Module, lr: float, weight_decay: float = 0.05,
               b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.optim.AdamW:
    params = dict(model.named_parameters())
    yes, no = decay_groups(model)
    return torch.optim.AdamW(
        [{"params": [params[n] for n in yes], "weight_decay": weight_decay},
         {"params": [params[n] for n in no], "weight_decay": 0.0}],
        lr=lr, betas=(b1, b2), eps=eps)


class RMSpropTF(torch.optim.Optimizer):
    """TF1-style RMSprop, per tensor:

        g   <- g + weight_decay·p
        sq  <- decay·sq + (1 - decay)·g²        (sq starts at ONES)
        buf <- momentum·buf + g / sqrt(sq + eps) (eps INSIDE the sqrt)
        p   <- p - lr·buf
    """

    def __init__(self, params, lr: float, decay: float = 0.9,
                 momentum: float = 0.9, eps: float = 1e-3,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, momentum=momentum,
                                      eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"] > 0:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.ones_like(p)
                    state["momentum_buffer"] = torch.zeros_like(p)
                sq, buf = state["square_avg"], state["momentum_buffer"]
                sq.mul_(group["decay"]).addcmul_(g, g,
                                                 value=1.0 - group["decay"])
                buf.mul_(group["momentum"]).add_(
                    g * torch.rsqrt(sq + group["eps"]))
                p.add_(buf, alpha=-group["lr"])
        return loss


def rmsprop_tf(params: Iterable, lr: float, decay: float = 0.9,
               momentum: float = 0.9, eps: float = 1e-3,
               weight_decay: float = 0.0) -> RMSpropTF:
    return RMSpropTF(params, lr, decay, momentum, eps, weight_decay)
