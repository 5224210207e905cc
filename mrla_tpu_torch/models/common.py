"""Shared conv-net building blocks (PyTorch, NCHW modules on channels_last
memory).

Init parity with the JAX package: convs are kaiming normal fan_out; BN
scale 1, bias 0, eps 1e-5; the last BN of every residual branch (bn3) is
zero-initialised when asked; Linear is U(±1/√fan_in) for weight and bias.

Module names follow the reference implementation's ``state_dict`` keys, so
the stem is two modules the model owns as ``conv1`` and ``bn1`` (the deep
stem's ``conv1`` an ``nn.Sequential``: ``conv1.{0,3,6}`` convs,
``conv1.{1,4}`` BNs), the
shortcut an ``nn.Sequential`` (``downsample.0`` conv, ``downsample.1`` BN)
and the classifier a top-level ``fc``.

In training, ``BatchNorm2d`` normalises with the batch statistics as
``nn.BatchNorm2d`` does, but updates the running variance with the
*biased* batch variance, as Flax's ``nn.BatchNorm`` (and so the JAX
package) does: ``running = 0.9·running + 0.1·batch``.  ``nn.BatchNorm2d``
would take the unbiased one, n / (n - 1) times larger.  Under data
parallelism (a process group of more than one rank) the batch is the
global batch, as the JAX step's under GSPMD: the per-channel fp32 sum, sum
of squares and count are all-reduced over the data group
(``parallel/launch.py:data_group``: the world, or inside ``with mesh:``
the mesh's ``data`` axis) by a differentiable sum, so the backward's two
sums are global too.  (``nn.SyncBatchNorm`` refuses CPU
tensors and updates the running variance with the unbiased variance.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.parallel import launch

BN_EPS = 1e-5


def _kaiming_fan_out(conv: nn.Conv2d,
                     generator: Optional[torch.Generator]) -> nn.Conv2d:
    out_ch, _, kh, kw = conv.weight.shape
    with torch.no_grad():
        conv.weight.normal_(0.0, math.sqrt(2.0 / (out_ch * kh * kw)),
                            generator=generator)
    return conv


def conv3x3(in_ch: int, out_ch: int, stride: int = 1,
            generator: Optional[torch.Generator] = None, groups: int = 1,
            dilation: int = 1) -> nn.Conv2d:
    return _kaiming_fan_out(
        nn.Conv2d(in_ch, out_ch, 3, stride, padding=dilation,
                  dilation=dilation, groups=groups, bias=False), generator
    )


def conv1x1(in_ch: int, out_ch: int, stride: int = 1,
            generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    return _kaiming_fan_out(
        nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), generator
    )


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running variance
    with the biased batch variance (the JAX package's rule) and, under data
    parallelism, takes its moments over the global batch; eval mode, the
    parameters and buffers are ``nn.BatchNorm2d``'s.  With ``momentum=None``
    (a cumulative average, which the JAX package has no counterpart of) it
    is ``nn.BatchNorm2d`` as it is.  ``update_stats = False`` leaves the
    running statistics as they are (a recomputed forward)."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats
                and self.momentum is not None):
            return super().forward(x)
        self._check_input_dim(x)
        if self.moment_group()[1] > 1:
            return self._global_batch_norm(x)
        return self._replica_batch_norm(x)

    def moment_group(self):
        """(group, size) the training moments are summed over: the data
        group."""
        return launch.data_group()

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Moments of the global batch: E[x] and E[x²] - E[x]² from the
        all-reduced sums (Flax's formula), in fp32."""
        xf = x.float()
        n = torch.full((1,), float(x.numel() // x.shape[1]),
                       device=x.device)
        sums = launch.all_reduce_sum(torch.cat(
            [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), n]),
            *self.moment_group())
        c = x.shape[1]
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias.float()[:, None, None]
        if self.update_stats:
            self.update_running_stats(mean.detach(), var.detach())
        return y.to(x.dtype)

    def _replica_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        m = self.momentum
        # the kernel updates copies (which autograd may keep): it adds
        # m·unbiased = var - (1 - m)·running_var; take away its 1 / n share
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m,
                         self.eps)
        if self.update_stats:
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                self.running_var.copy_(
                    var - (var - (1.0 - m) * self.running_var) / n)
                self.running_mean.copy_(mean)
                self.num_batches_tracked.add_(1)
        return y

    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        """Fold one batch's mean and biased variance (fp32 [C]) into the
        running statistics by the same rule (the fused train epilogue's
        update)."""
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)


def batch_norm(channels: int, zero_init: bool = False) -> BatchNorm2d:
    """BatchNorm with torch defaults (eps 1e-5, running-stat momentum 0.1)
    and the JAX package's running-variance rule (``BatchNorm2d``)."""
    bn = BatchNorm2d(channels, eps=BN_EPS)
    if zero_init:
        nn.init.zeros_(bn.weight)
    return bn


def stem7x7(width: int = 64, generator: Optional[torch.Generator] = None
            ) -> tuple[nn.Conv2d, BatchNorm2d]:
    """The classic ResNet stem's 7x7/2 conv and its BN (ReLU and max pool
    are applied by the model)."""
    conv = _kaiming_fan_out(
        nn.Conv2d(3, width, 7, 2, padding=3, bias=False), generator
    )
    return conv, batch_norm(width)


def deep_stem(stem_width: int = 32, out_width: int = 64,
              generator: Optional[torch.Generator] = None
              ) -> tuple[nn.Sequential, BatchNorm2d]:
    """MRLA-base's 3-conv stem: 3x3/2 -> BN -> ReLU -> 3x3 -> BN -> ReLU ->
    3x3, and the BN after it (its ReLU and the max pool are applied by the
    model)."""
    conv = nn.Sequential(
        conv3x3(3, stem_width, 2, generator), batch_norm(stem_width),
        nn.ReLU(inplace=True),
        conv3x3(stem_width, stem_width, generator=generator),
        batch_norm(stem_width), nn.ReLU(inplace=True),
        conv3x3(stem_width, out_width, generator=generator))
    return conv, batch_norm(out_width)


def downsample(in_ch: int, out_ch: int, stride: int,
               generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """1x1-conv + BN shortcut projection."""
    return nn.Sequential(conv1x1(in_ch, out_ch, stride, generator),
                         batch_norm(out_ch))


def classifier_fc(in_features: int, num_classes: int,
                  generator: Optional[torch.Generator] = None) -> nn.Linear:
    """The classification head's Linear (applied after a fp32 GAP)."""
    fc = nn.Linear(in_features, num_classes)
    lim = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        fc.weight.uniform_(-lim, lim, generator=generator)
        fc.bias.uniform_(-lim, lim, generator=generator)
    return fc
