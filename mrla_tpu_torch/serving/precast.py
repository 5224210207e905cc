"""The generic serving engine ("precast"): any model of the registry that
has no dedicated engine, served as its own ``nn.Module`` with its weights
cast once.

``prepare_precast_inference_params`` builds the model on the device (from
an arch name, or a copy of a model instance), loads a ``state_dict`` and
casts every weight to the serving dtype once, except the normalisations'
(every ``BatchNorm2d``, ``LayerNorm`` and ResMLP ``Affine`` keeps its
weights and statistics fp32: the JAX package's rule, which keeps any leaf
under a Flax module named ``*norm*`` or ``*bn*``, stated by module type
because the port's names differ, e.g. a shortcut BN is ``downsample.1``).
``precast_forward`` serves ``model(x)`` in eval mode with fp32 logits;
the models compute what the JAX package's do with a bf16 ``dtype``: BN and
LayerNorm in fp32 rounded once to bf16, the SE projections in fp32 from
bf16-rounded weights.

It serves the baseline ResNet / ResNeXt (SE, ECA, the dw ablation),
EfficientNet-B0 (with MRLA), ResMLP and PatchConvNet archs and the plain
``deit_*`` archs.  The resnet mrlal / mrlab archs and the DeiT-MRLA archs
have their own engines (``serving/resnet_mrlal.py``, ``resnet_mrlab.py``,
``deit.py``), and this one refuses them.

``microbatch`` > 0 runs the trunk (``forward_features``) chain by chain
and the head (``forward_head``) once over their outputs, as the other
engines do (``serving/microbatch.py``).
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Union

import torch
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.models.deit import VisionTransformer
from mrla_tpu_torch.models.efficientnet_mrla import EfficientNet
from mrla_tpu_torch.models.patchconvnet import PatchConvNet
from mrla_tpu_torch.models.registry import create_model
from mrla_tpu_torch.models.resmlp import Affine, ResMLP
from mrla_tpu_torch.models.resnet import ResNet
from mrla_tpu_torch.serving.microbatch import chains

# modules whose weights (and statistics) stay fp32
FP32_MODULES = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm, Affine)
SERVED = (ResNet, EfficientNet, ResMLP, PatchConvNet)


def cast_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every floating weight and buffer of ``model`` to ``dtype``, those of
    ``FP32_MODULES`` to fp32; in place."""
    for m in model.modules():
        to = torch.float32 if isinstance(m, FP32_MODULES) else dtype
        for p in m.parameters(recurse=False):
            p.data = p.data.to(to)
        for name, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(m, name, b.to(to))
    return model


def prepare_precast_inference_params(
    arch_or_model: Union[str, nn.Module],
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    **model_kw,
) -> nn.Module:
    """The model on ``device`` in eval mode with its weights cast; what
    ``precast_forward`` serves.  ``arch_or_model`` is a registered name
    (built with ``model_kw``) or a model instance (copied, so the caller's
    stays as it is); ``state_dict`` gives the weights and must hold exactly
    the model's keys (a ``module.`` prefix is stripped); None keeps the
    model's own."""
    dev = resolve_device(device)
    model = (create_model(arch_or_model, device="cpu", **model_kw)
             if isinstance(arch_or_model, str)
             else copy.deepcopy(arch_or_model))
    if not (isinstance(model, SERVED) or type(model) is VisionTransformer):
        raise ValueError(
            f"{type(model).__name__} has its own serving engine "
            "(serving/resnet_mrlal.py, resnet_mrlab.py or deit.py)")
    if state_dict is not None:
        model.load_state_dict({k.removeprefix("module."): v
                               for k, v in state_dict.items()}, strict=True)
    model = cast_weights(model.float(), dtype)
    return model.to(dev, memory_format=torch.channels_last).eval()


@torch.inference_mode()
def precast_forward(model: nn.Module, x: torch.Tensor,
                    microbatch: int = 0) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the weights' dtype) on
    the model's device -> logits [B, classes] fp32.  ``microbatch`` > 0
    serves the batch as chains of that many images, one after another, and
    the head takes their outputs together; 0, the default, serves it
    unsplit."""
    dev = next(model.parameters()).device
    if x.device != dev:
        raise ValueError(f"images are on {x.device}, the model on {dev}")
    parts = chains(x, microbatch)
    feats = (model.forward_features(x) if parts is None
             else torch.cat([model.forward_features(p) for p in parts]))
    return model.forward_head(feats).float()
