from mrla_tpu_torch.models.deit import (
    Attention,
    Mlp,
    PatchEmbed,
    ViTBlock,
    VisionTransformer,
)
from mrla_tpu_torch.models.deit_mrla import (
    MRLABaseTokenModule,
    MRLABaseViTBlock,
    MRLALightTokenModule,
    MRLAViTBlock,
    ViTMRLA,
)
from mrla_tpu_torch.models import patchconvnet, resmlp, resnet  # noqa: F401
from mrla_tpu_torch.models.efficientnet_mrla import (
    EfficientNet,
    MBConv,
    efficientnet_b0,
    efficientnet_mrlal_b0,
)
from mrla_tpu_torch.models.patchconvnet import PatchConvNet
from mrla_tpu_torch.models.registry import create_model, list_models, register_model
from mrla_tpu_torch.models.resmlp import Affine, ResMLP
from mrla_tpu_torch.models.resnet import Bottleneck, ResNet
from mrla_tpu_torch.models.resnet_la_eq4 import (
    LAEq4Bottleneck,
    ResNetLAEq4,
    resnet50_la_eq4,
    resnet101_la_eq4,
)
from mrla_tpu_torch.models.resnet_mrla_base import (
    MRLABaseBottleneck,
    ResNetMRLABase,
    resnet50_mrlab,
    resnet50_mrlab22,
    resnet101_mrlab,
    resnet152_mrlab,
)
from mrla_tpu_torch.models.resnet_mrla_light import (
    MRLABottleneck,
    ResNetMRLALight,
    resnet50_mrlal,
    resnet101_mrlal,
    resnet152_mrlal,
)

__all__ = [
    "Affine",
    "Attention",
    "Bottleneck",
    "EfficientNet",
    "LAEq4Bottleneck",
    "MBConv",
    "MRLABaseBottleneck",
    "MRLABaseTokenModule",
    "MRLABaseViTBlock",
    "MRLABottleneck",
    "MRLALightTokenModule",
    "MRLAViTBlock",
    "Mlp",
    "PatchConvNet",
    "PatchEmbed",
    "ResMLP",
    "ResNet",
    "ResNetLAEq4",
    "ResNetMRLABase",
    "ResNetMRLALight",
    "ViTBlock",
    "ViTMRLA",
    "VisionTransformer",
    "create_model",
    "efficientnet_b0",
    "efficientnet_mrlal_b0",
    "list_models",
    "register_model",
    "resnet50_la_eq4",
    "resnet50_mrlab",
    "resnet50_mrlab22",
    "resnet50_mrlal",
    "resnet101_la_eq4",
    "resnet101_mrlab",
    "resnet101_mrlal",
    "resnet152_mrlab",
    "resnet152_mrlal",
]
