"""Plain PyTorch reference of ResNet with MRLA-light in every bottleneck
(arXiv:2302.03985, the reference implementation's ``resnet/`` models on
ResNet, arXiv:1512.03385), on the state dict the benchmark draws.

    block:  out = relu(bn1(conv1 x)); out = relu(bn2(conv2 out, stride))
            out = relu(bn3(conv3 out) + identity)     identity: x, or
                                                      bn(1x1 conv, stride)
            g   = per-head sigmoid(q . k / sqrt(d)), q and k the k-tap
                  channel convs Wq, Wk of the global average of out
            out = out + bn_mrla(dwconv3x3(out; Wv) * g + lambda * identity)

with a 7 x 7 stride-2 stem, BN, ReLU, a 3 x 3 stride-2 max pool, and the
head fc(mean over the map).  Images are NHWC and go in as NCHW.  Every
BatchNorm is computed as it is written (eval: running statistics; train:
the batch's mean and biased variance, each running statistic moved a
tenth of the way to the batch's, the biased variance included, as the
configuration's trainer states), nothing folded, float32.

``spec`` lists the state dict (the reference implementation's key
names) with the benchmark's init rules; ``calibrate`` sets every BN's
running statistics from one batch.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import common, init
from portbench.reference.common import FP32, Precision

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
HEAD = "fc.weight"  # the output layer's weight


def _blocks(cfg: dict) -> Iterator[Tuple[str, int, int, int, bool]]:
    """(prefix, in channels, planes, stride, has downsample) of each
    bottleneck."""
    inplanes, planes = cfg["stem_width"], cfg["stem_width"]
    for s, n in enumerate(cfg["layers"]):
        for b in range(n):
            first = b == 0
            yield (f"layer{s + 1}.{b}", inplanes, planes,
                   2 if (first and s > 0) else 1, first)
            inplanes = planes * cfg["expansion"]
        planes *= 2


def spec(cfg: dict) -> init.Spec:
    """The state dict's leaves and init rules: kaiming fan-out convs, the
    last BN of each residual branch (bn3) and bn_mrla scaled U(0.1, 0.5)
    so that every branch and the cross-layer term reach the logits, the
    other BN scales U(0.5, 1.5), BN biases N(0, 0.1), the MRLA taps
    U(-1, 1) (so that the gates leave 1/2), the depthwise Wv kaiming,
    lambda N(0, 1), the fc U(+-1/sqrt(fan_in))."""
    w = cfg["stem_width"]
    out: init.Spec = [("conv1.weight", (w, 3, 7, 7),
                       init.kaiming_fan_out((w, 3, 7, 7)))]
    out += init.batch_norm("bn1", w, ("uniform", 0.5, 1.5), 0.1)
    e = cfg["expansion"]
    for pre, cin, p, _, down in _blocks(cfg):
        c = p * e
        for i, shape in ((1, (p, cin, 1, 1)), (2, (p, p, 3, 3)),
                         (3, (c, p, 1, 1))):
            out.append((f"{pre}.conv{i}.weight", shape,
                        init.kaiming_fan_out(shape)))
            out += init.batch_norm(
                f"{pre}.bn{i}", shape[0],
                ("uniform", 0.1, 0.5) if i == 3 else ("uniform", 0.5, 1.5),
                0.1)
        if down:
            shape = (c, cin, 1, 1)
            out.append((f"{pre}.downsample.0.weight", shape,
                        init.kaiming_fan_out(shape)))
            out += init.batch_norm(f"{pre}.downsample.1", c,
                                   ("uniform", 0.5, 1.5), 0.1)
        k = common.eca_kernel_size(c)
        out += [(f"{pre}.mrla.mrla.Wq.weight", (1, 1, k),
                 ("uniform", -1.0, 1.0)),
                (f"{pre}.mrla.mrla.Wk.weight", (1, 1, k),
                 ("uniform", -1.0, 1.0)),
                (f"{pre}.mrla.mrla.Wv.weight", (c, 1, 3, 3),
                 init.kaiming_fan_out((c, 1, 3, 3))),
                (f"{pre}.mrla.lambda_t", (c, 1, 1), ("normal", 0.0, 1.0))]
        out += init.batch_norm(f"{pre}.bn_mrla", c, ("uniform", 0.1, 0.5),
                               0.1)
    c = w * e * 2 ** (len(cfg["layers"]) - 1)
    lim = 1.0 / math.sqrt(c)
    out += [("fc.weight", (cfg["num_classes"], c), ("uniform", -lim, lim)),
            ("fc.bias", (cfg["num_classes"],), ("uniform", -lim, lim))]
    return out


class _Net:
    """One forward over the state dict ``sd``.  ``bn``: "eval" (running
    statistics), "train" (batch statistics, the running ones in ``sd``
    moved toward them) or "calibrate" (batch statistics, written into
    ``sd`` as the running ones)."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, bn: str,
                 q: Precision):
        self.sd, self.cfg, self.mode, self.q = sd, cfg, bn, q

    def bn(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        sd = self.sd
        w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
        if self.mode == "eval":
            mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
        else:
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
            with torch.no_grad():
                rm, rv = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
                if self.mode == "calibrate":
                    rm.copy_(mean)
                    rv.copy_(var)
                else:
                    rm.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                    rv.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
        inv = torch.rsqrt(var + BN_EPS) * w
        return (x - mean[:, None, None]) * inv[:, None, None] + b[:, None, None]

    def conv(self, x, name: str, stride: int = 1) -> torch.Tensor:
        w = self.sd[name]
        return common.conv2d(self.q, x, w, stride=stride,
                             padding=w.shape[-1] // 2)

    def block(self, x, pre: str, stride: int, down: bool) -> torch.Tensor:
        out = F.relu(self.bn(self.conv(x, f"{pre}.conv1.weight"), f"{pre}.bn1"))
        out = F.relu(self.bn(self.conv(out, f"{pre}.conv2.weight", stride),
                             f"{pre}.bn2"))
        out = self.bn(self.conv(out, f"{pre}.conv3.weight"), f"{pre}.bn3")
        identity = (self.bn(self.conv(x, f"{pre}.downsample.0.weight", stride),
                            f"{pre}.downsample.1") if down else x)
        out = F.relu(out + identity)
        sd, c = self.sd, out.shape[1]
        gate = common.head_gate(out.mean((2, 3)),
                                sd[f"{pre}.mrla.mrla.Wq.weight"],
                                sd[f"{pre}.mrla.mrla.Wk.weight"],
                                c // self.cfg["dim_perhead"])
        v = common.conv2d(self.q, out, sd[f"{pre}.mrla.mrla.Wv.weight"],
                          padding=1, groups=c)
        m = v * gate[:, :, None, None] + sd[f"{pre}.mrla.lambda_t"] * identity
        return out + self.bn(m, f"{pre}.bn_mrla")

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float().permute(0, 3, 1, 2)
        x = F.relu(self.bn(self.conv(x, "conv1.weight", 2), "bn1"))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for pre, _, _, stride, down in _blocks(self.cfg):
            x = self.block(x, pre, stride, down)
        return common.linear(self.q, x.mean((2, 3)), self.sd["fc.weight"],
                             self.sd["fc.bias"])


@torch.no_grad()
def calibrate(sd: Dict[str, torch.Tensor], cfg: dict,
              images: torch.Tensor) -> None:
    """Every BN's running statistics set to its input's mean and biased
    variance over ``images`` (one forward, each BN normalising with the
    statistics it sets)."""
    with common.exact_fp32():
        _Net(sd, cfg, "calibrate", FP32)(images)


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
            q: Precision = FP32) -> torch.Tensor:
    """Eval-mode logits [B, classes] fp32 of NHWC ``images``."""
    with common.exact_fp32():
        return _Net(sd, cfg, "eval", q)(images)


def train_loss(params: Dict[str, torch.Tensor], sd: Dict[str, torch.Tensor],
               cfg: dict, images: torch.Tensor, targets: torch.Tensor,
               gen, recipe: dict, q: Precision = FP32) -> torch.Tensor:
    """The training loss of one batch: the forward with BN on the batch's
    statistics (the running ones in ``sd`` updated), soft-target cross
    entropy.  ``params`` (leaves with gradients) take the place of their
    entries of ``sd``.  The recipe's
    stochastic depth is 0 for this family; ``gen`` is unused."""
    if recipe.get("drop_path", 0.0):
        raise ValueError("the resnet reference takes no stochastic depth")
    logits = _Net({**sd, **params}, cfg, "train", q)(images)
    return common.soft_ce(logits, targets)


def decayed(name: str, p: torch.Tensor) -> bool:
    """SGD decays every leaf; AdamW's timm rule would leave out rank < 2
    and the channel taps (not used by this family's recipe)."""
    return True
