"""ResNet with the MRLA-light epilogue (the flagship family).

Block: bottleneck -> (+identity, relu) -> out + DropPath(BN(mrla(out) +
λ·identity)), with dim_perhead=32 and λ ~ N(0, 1); 7x7 stem; zero-init bn3.

The module tree and ``state_dict`` keys are the reference implementation's
(``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}``, ``layer{s}.{b}.downsample.{0,1}``,
``layer{s}.{b}.mrla.mrla.W{q,k,v}``, ``layer{s}.{b}.mrla.lambda_t``,
``layer{s}.{b}.bn_mrla``, ``fc``), so published checkpoints load as they are.

``forward`` takes NHWC images and returns fp32 logits; inside, the network
runs on NCHW views of NHWC memory (channels_last strides).  With
``features_only=True`` the model has no ``fc`` and returns the per-stage
maps (C2, C3, C4, C5) as NHWC views instead: the MMDetection backbone
contract, whose epilogue has no DropPath.

Training (``model.train()``): BN on batch statistics (the JAX package's
running-variance rule, ``models/common.py``); DropPath at ``drop_path`` on
every epilogue and dropout at ``drop_rate`` before ``fc``, their masks from
the generator ``nn.set_generator`` hands them; ``remat`` recomputes each
block in the backward (``torch.utils.checkpoint``, the same masks, the
running statistics updated once); ``fused_epilogue`` runs each block's tail
as one autograd ``Function`` (``ops/fused_train.py``) when DropPath is
inactive, as the JAX model does.  Eval mode ignores all four.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mrla_tpu_torch.models.common import (
    BatchNorm2d,
    batch_norm,
    classifier_fc,
    conv1x1,
    conv3x3,
    downsample,
    stem7x7,
)
from mrla_tpu_torch.models.registry import register_model
from mrla_tpu_torch.nn.layers import DropPath, Dropout, MRLALightModule
from mrla_tpu_torch.ops.fused_train import fused_light_epilogue_train


class MRLABottleneck(nn.Module):
    """Bottleneck + MRLA-light epilogue."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dim_perhead: int = 32,
                 zero_init_last_bn: bool = True, drop_path: float = 0.0,
                 use_drop_path: bool = True, fused_epilogue: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.fused_epilogue = fused_epilogue
        self.conv1 = conv1x1(inplanes, planes, generator=generator)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv3x3(planes, planes, stride, generator=generator)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv1x1(planes, out_ch, generator=generator)
        self.bn3 = batch_norm(out_ch, zero_init=zero_init_last_bn)
        self.downsample = (
            downsample(inplanes, out_ch, stride, generator)
            if use_downsample else None
        )
        self.mrla = MRLALightModule(out_ch, dim_perhead, generator=generator)
        self.bn_mrla = batch_norm(out_ch)
        self.drop_path = DropPath(drop_path) if use_drop_path else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(out + identity)
        drop = self.drop_path is not None and self.drop_path.rate > 0.0
        if self.fused_epilogue and self.training and not drop:
            return self._fused_tail(out, identity)
        # the recurrence input o_{t-1} is this block's (downsampled) identity
        y = self.bn_mrla(self.mrla(out, identity))
        return out + (self.drop_path(y) if drop else y)

    def _fused_tail(self, out: torch.Tensor,
                    identity: torch.Tensor) -> torch.Tensor:
        """The tail in training as one autograd Function, bn_mrla's running
        statistics updated from the batch mean and variance it returns."""
        proj, bn = self.mrla.mrla, self.bn_mrla
        ret, mean, var = fused_light_epilogue_train(
            out.permute(0, 2, 3, 1), identity.permute(0, 2, 3, 1),
            proj.Wq.weight, proj.Wk.weight, proj.Wv.weight,
            self.mrla.lambda_t.reshape(-1), bn.weight, bn.bias, proj.heads)
        if bn.update_stats:
            bn.update_running_stats(mean, var)
        return ret.permute(0, 3, 1, 2)


class ResNetMRLALight(nn.Module):
    """ResNet_mrlal classifier."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 dim_perhead: int = 32,
                 generator: Optional[torch.Generator] = None,
                 features_only: bool = False, drop_rate: float = 0.0,
                 drop_path: float = 0.0, remat: bool = False,
                 fused_epilogue: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.features_only = features_only
        self.drop_rate, self.drop_path = drop_rate, drop_path
        self.remat = remat
        self.conv1, self.bn1 = stem7x7(64, generator)
        inplanes, planes = 64, 64
        for stage_idx, blocks in enumerate(layers):
            stage = []
            for block_idx in range(blocks):
                first = block_idx == 0
                stage.append(MRLABottleneck(
                    inplanes, planes,
                    stride=2 if (first and stage_idx > 0) else 1,
                    use_downsample=first, dim_perhead=dim_perhead,
                    drop_path=drop_path, use_drop_path=not features_only,
                    fused_epilogue=fused_epilogue, generator=generator,
                ))
                inplanes = planes * MRLABottleneck.expansion
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*stage))
            planes *= 2
        if not features_only:
            self.head_drop = Dropout(drop_rate)
            self.fc = classifier_fc(inplanes, num_classes, generator)

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] -> logits [B, num_classes] fp32, or with
        ``features_only`` the tuple of per-stage NHWC maps."""
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage_idx in range(len(self.layers)):
            for block in getattr(self, f"layer{stage_idx + 1}"):
                x = remat_block(block, x) if remat else block(x)
            outs.append(x.permute(0, 2, 3, 1))
        if self.features_only:
            return tuple(outs)
        return self.fc(self.head_drop(x.mean(dim=(2, 3)))).float()


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` whose activations the backward recomputes
    (``torch.utils.checkpoint``).  The recompute draws the same DropPath /
    dropout masks (their generators are set back to the states of the first
    call, then forward again) and leaves the BN running statistics as the
    first call left them."""
    gens = {m.generator for m in block.modules()
            if isinstance(m, (DropPath, Dropout)) and m.generator is not None}
    before = [(g, g.get_state()) for g in gens]
    calls = []

    def run(inp):
        calls.append(None)
        if len(calls) == 1:
            return block(inp)
        after = [(g, g.get_state()) for g, _ in before]
        for g, state in before:
            g.set_state(state)
        bns = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.update_stats = False
        try:
            return block(inp)
        finally:
            for m in bns:
                del m.update_stats
            for g, state in after:
                g.set_state(state)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


@register_model
def resnet50_mrlal(**kw):
    return ResNetMRLALight(layers=[3, 4, 6, 3], **kw)


@register_model
def resnet101_mrlal(**kw):
    return ResNetMRLALight(layers=[3, 4, 23, 3], **kw)


@register_model
def resnet152_mrlal(**kw):
    return ResNetMRLALight(layers=[3, 8, 36, 3], **kw)
