"""The train and eval steps (the JAX package's ``train/steps.py``).

``train_step``: the schedule's lr for this step, the forward in training
mode (under ``torch.autocast`` bf16 when asked: fp32 parameters, bf16
compute), the loss, the backward, an optional global-norm clip
(g·min(1, c / (‖g‖ + 1e-6)), as ``clip_grad_norm_``), the optimizer step,
the EMA.  Under data parallelism the forward runs through ``state.ddp``,
which averages the gradients over the ranks (each rank's loss a mean over
its rows of the global batch).  With a teacher (DeiT distillation), the teacher runs in eval
mode under ``no_grad``; a distilled student returns (cls, dist) in
training, the base loss goes on the cls head and the distillation term on
the dist head; a plain model's one head takes both.

``eval_step``: summed top-1 / top-5 / count over a batch, the rows whose
``valid`` is false left out (padding of a ragged last batch).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from mrla_tpu_torch.train.losses import cross_entropy, distillation_loss
from mrla_tpu_torch.train.state import TrainState, update_ema


def _autocast(device: torch.device, bf16: bool):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               loss_fn: Callable = cross_entropy,
               grad_clip_norm: Optional[float] = None,
               teacher: Optional[nn.Module] = None,
               distill_kind: str = "none", distill_alpha: float = 0.5,
               distill_tau: float = 1.0,
               bf16: bool = False) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` ({"image": [B, H, W, 3], "label": [B] int or
    [B, K] soft}, on the model's device).  Returns {"loss"} (and
    "accuracy" for hard labels), device scalars."""
    model, images, labels = state.model, batch["image"], batch["label"]
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    model.train()
    with _autocast(images.device, bf16):
        logits = (model if state.ddp is None else state.ddp)(images)
        cls, dist = logits if isinstance(logits, tuple) else (logits, logits)
        loss = loss_fn(cls, labels)
        if teacher is not None and distill_kind != "none":
            with torch.no_grad():
                t_logits = teacher.eval()(images)
            loss = distillation_loss(loss, dist, t_logits, kind=distill_kind,
                                     alpha=distill_alpha, tau=distill_tau)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if grad_clip_norm is not None:
        nn.utils.clip_grad_norm_(
            [p for p in model.parameters() if p.grad is not None],
            grad_clip_norm)
    state.optimizer.step()
    state.step += 1
    if state.ema is not None:
        update_ema(state)
    metrics = {"loss": loss.detach()}
    if labels.ndim == 1:
        metrics["accuracy"] = (cls.detach().argmax(-1) == labels).float(
            ).mean()
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              use_ema: bool = False,
              bf16: bool = False) -> Dict[str, torch.Tensor]:
    """{"top1", "top5", "count"}: summed over the batch's valid rows."""
    if use_ema and state.ema is None:
        raise ValueError("use_ema=True but the state has no EMA: restore a "
                         "state trained with --ema-decay or evaluate "
                         "without EMA")
    model = (state.ema if use_ema else state.model).eval()
    images, labels = batch["image"], batch["label"].long()
    with _autocast(images.device, bf16):
        logits = model(images).float()
    k = min(5, logits.shape[-1])
    top = logits.topk(k, dim=-1).indices  # [B, k]
    hit = top == labels[:, None]
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones_like(labels, dtype=torch.bool)
    return {"top1": (hit[:, 0] & valid).sum(),
            "top5": (hit.any(-1) & valid).sum(),
            "count": valid.sum()}
