"""Plain PyTorch pieces the references share.

Everything here is float32 with TF32 off (``exact_fp32``), unless the
reference is asked for a lower precision: then ``Precision`` rounds every
matrix product's and convolution's operands, and the gradients of their
outputs: to float8 for the control of the correctness check, to bfloat16
for a witness of what bfloat16 alone does.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def eca_kernel_size(channels: int) -> int:
    """The ECA rule for the channel taps of MRLA's Wq / Wk:
    t = int(|log2(C) + 1| / 2), k = t if t is odd else t + 1."""
    t = int(abs((math.log2(channels) + 1) / 2.0))
    return t if t % 2 else t + 1


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matrix products and cuDNN inside, restored after."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        before = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = before


def _round(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` rounded to bfloat16, or to float8 (``e4m3`` or ``e5m2``)
    scaled so that its absolute maximum lands on the format's largest
    finite value, and back to ``t``'s dtype."""
    if kind == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    fmt = FP8[kind]
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(t.dtype) * scale


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded on its way back."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind), None


class Precision:
    """The precision of the reference's products: float32 (the default);
    ``bf16=True``, operands and the gradients of outputs rounded to
    bfloat16, as autocast computes; ``fp8=True``, FP8 training's hybrid
    recipe: operands in float8 e4m3, the gradients of outputs in e5m2,
    each tensor scaled to its format's range.  Products accumulate in
    float32 either way; the gradient passes the operand rounding
    straight through."""

    def __init__(self, fp8: bool = False, bf16: bool = False):
        self.fp8, self.bf16 = fp8, bf16
        self.fwd = "e4m3" if fp8 else "bf16" if bf16 else None
        self.bwd = "e5m2" if fp8 else "bf16" if bf16 else None

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        if self.fwd is None:
            return t
        with torch.no_grad():
            q = _round(t, self.fwd)
        return t + (q - t).detach() if t.requires_grad else q

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """A product's output: its gradient rounded on the way back."""
        if self.bwd is None or not t.requires_grad:
            return t
        return _RoundGrad.apply(t, self.bwd)


FP32 = Precision(False)


def conv2d(q: Precision, x, w, b=None, stride=1, padding=0, groups=1):
    return q.out(F.conv2d(q(x), q(w), b, stride=stride, padding=padding,
                          groups=groups))


def linear(q: Precision, x, w, b=None):
    return q.out(F.linear(q(x), q(w), b))


def channel_taps(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, C] descriptor cross-correlated along C with k taps, zero padded
    (k - 1) / 2 on each side: out[c] = sum_j w[j] y[c + j - (k - 1) / 2]."""
    k = w.numel()
    b, c = y.shape
    return F.conv1d(y.reshape(b, 1, c), w.reshape(1, 1, k),
                    padding=(k - 1) // 2).reshape(b, c)


def head_gate(y: torch.Tensor, wq, wk, heads: int) -> torch.Tensor:
    """MRLA-light's per-head sigmoid gate of a [B, C] descriptor, repeated
    over each head's C / heads channels -> [B, C]."""
    b, c = y.shape
    d = c // heads
    q = channel_taps(y, wq).reshape(b, heads, d)
    k = channel_taps(y, wk).reshape(b, heads, d)
    attn = torch.sigmoid((q * k).sum(-1) / math.sqrt(d))
    return attn.repeat_interleave(d, dim=1)


def label_smoothing_targets(labels: torch.Tensor, classes: int,
                            eps: float) -> torch.Tensor:
    """(1 - eps) one-hot + eps / K."""
    off = eps / classes
    return F.one_hot(labels, classes).float() * (1.0 - eps) + off


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -sum targets * log_softmax(logits)."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def mixup_cutmix(rng: np.random.Generator, images: torch.Tensor,
                 labels: torch.Tensor, classes: int, mixup_alpha: float,
                 cutmix_alpha: float, label_smoothing: float,
                 switch_prob: float = 0.5):
    """timm's batch Mixup / CutMix (the DeiT recipe): CutMix with
    probability ``switch_prob``, else Mixup, each image mixed with the
    image at the mirrored batch position; soft targets mixed alike.
    ``images`` NHWC fp32.  One draw from ``rng`` a batch, in this order:
    the switch, then Beta(a, a), then for CutMix the box centre (y, x)."""
    _, h, w, _ = images.shape
    if rng.random() < switch_prob:
        lam = rng.beta(cutmix_alpha, cutmix_alpha)
        cut = np.sqrt(1.0 - lam)
        ch, cw = int(h * cut), int(w * cut)
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        y0, y1 = np.clip([cy - ch // 2, cy + ch // 2], 0, h)
        x0, x1 = np.clip([cx - cw // 2, cx + cw // 2], 0, w)
        lam = float(1.0 - (y1 - y0) * (x1 - x0) / (h * w))
        out = images.clone()
        out[:, y0:y1, x0:x1] = images.flip(0)[:, y0:y1, x0:x1]
    else:
        lam = float(rng.beta(mixup_alpha, mixup_alpha))
        out = lam * images + (1.0 - lam) * images.flip(0)
    off = label_smoothing / classes
    on = 1.0 - label_smoothing + off
    t1 = F.one_hot(labels, classes).float() * (on - off) + off
    return out, lam * t1 + (1.0 - lam) * t1.flip(0)


def drop_path(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Per-sample stochastic depth: one uniform a sample from ``gen``,
    kept below 1 - rate and scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


# ------------------------------------------------------------ optimizers

def step_lr(base: float, step: int, steps_per_epoch: int,
            warmup_epochs: int, decay_every: int = 30,
            factor: float = 0.1) -> float:
    """Linear warm-up, then base * factor ** (epoch // decay_every)."""
    f = np.float32
    epoch = f(step) / f(steps_per_epoch)
    if warmup_epochs > 0 and epoch < warmup_epochs:
        return float(f(base) * (epoch + f(1e-8)) / f(warmup_epochs))
    return float(f(base) * f(factor) ** np.floor(epoch / f(decay_every)))


def cosine_lr(base: float, step: int, steps_per_epoch: int,
              warmup_epochs: int, epochs: int) -> float:
    """Linear warm-up from base / warm-up steps, then a cosine to 0."""
    f = np.float32
    total, warm = epochs * steps_per_epoch, warmup_epochs * steps_per_epoch
    if warm > 0 and step < warm:
        return float(f(base) * f(step + 1) / f(warm))
    t = f(step - warm) / f(max(total - warm, 1))
    return float(f(0.5) * f(base) * (f(1) + np.cos(f(np.pi) * t)))


def learning_rate(recipe: dict, step: int, steps_per_epoch: int) -> float:
    base = recipe["lr"]
    if recipe.get("lr_scale_512"):
        base = base * recipe["batch"] / 512.0
    if recipe["scheduler"] == "step":
        return step_lr(base, step, steps_per_epoch, recipe["warmup_epochs"])
    if recipe["scheduler"] == "cosine":
        return cosine_lr(base, step, steps_per_epoch,
                         recipe["warmup_epochs"], recipe["epochs"])
    raise ValueError(f"no reference for scheduler {recipe['scheduler']!r}")


class SGD:
    """Momentum SGD, weight decay added to the gradient before the
    momentum buffer, every leaf decayed, no dampening."""

    def __init__(self, params: dict, momentum: float, weight_decay: float):
        self.params, self.mu, self.wd = params, momentum, weight_decay
        self.buf = {}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        for n, p in self.params.items():
            d = grads[n] + self.wd * p
            self.buf[n] = d if n not in self.buf else self.mu * self.buf[n] + d
            p.sub_(lr * self.buf[n])


class AdamW:
    """AdamW with decoupled weight decay on the leaves ``decay`` names."""

    def __init__(self, params: dict, decay: set, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.decay, self.wd = params, decay, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            if n in self.decay:
                p.mul_(1.0 - lr * self.wd)
            m = self.m.get(n, torch.zeros_like(p)).mul_(self.b1).add_(
                g, alpha=1.0 - self.b1)
            v = self.v.get(n, torch.zeros_like(p)).mul_(self.b2).addcmul_(
                g, g, value=1.0 - self.b2)
            self.m[n], self.v[n] = m, v
            p.addcdiv_(m, (v.sqrt() / math.sqrt(c2)).add_(self.eps),
                       value=-lr / c1)
