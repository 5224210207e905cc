"""Classification losses (the JAX package's ``train/losses.py``).

``label_smoothing_ce`` is the reference's CrossEntropyLabelSmooth: the mean
over the batch of -Σ ((1 - ε)·onehot + ε / K) · log_softmax.  Every loss
takes fp32 logits (a model's output; cast otherwise) and returns a scalar.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; integer labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def label_smoothing_ce(logits: torch.Tensor, labels: torch.Tensor,
                       epsilon: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE matching the reference's CrossEntropyLabelSmooth."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    targets = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-(targets * logp).sum(-1)).mean()


def soft_target_ce(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """CE against soft targets (the Mixup / CutMix paths; timm's
    SoftTargetCrossEntropy)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-(targets.float() * logp).sum(-1)).mean()


def distillation_loss(base_loss: torch.Tensor,
                      student_dist_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, kind: str = "none",
                      alpha: float = 0.5,
                      tau: float = 1.0) -> torch.Tensor:
    """DeiT distillation.

    kind='soft': KL(teacher/τ ‖ student/τ)·τ², blended with the base loss by
    α; kind='hard': CE against the teacher's argmax; kind='none': the base
    loss unchanged."""
    if kind == "none":
        return base_loss
    s = student_dist_logits.float()
    t = teacher_logits.float()
    if kind == "soft":
        logp_s = F.log_softmax(s / tau, dim=-1)
        logp_t = F.log_softmax(t / tau, dim=-1)
        kl = (logp_t.exp() * (logp_t - logp_s)).sum(-1)
        # summed, τ² scaled and divided by numel = B·K: the reference's
        # kl_div(reduction='sum') · τ² / numel; without the / K the term
        # is num_classes times too large
        dist = kl.mean() * (tau ** 2) / s.shape[-1]
    elif kind == "hard":
        dist = cross_entropy(s, t.argmax(-1))
    else:
        raise ValueError(f"unknown distillation kind: {kind}")
    return base_loss * (1.0 - alpha) + dist * alpha
