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
from mrla_tpu_torch.models.registry import create_model, list_models, register_model
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
    "Attention",
    "LAEq4Bottleneck",
    "MRLABaseBottleneck",
    "MRLABaseTokenModule",
    "MRLABaseViTBlock",
    "MRLABottleneck",
    "MRLALightTokenModule",
    "MRLAViTBlock",
    "Mlp",
    "PatchEmbed",
    "ResNetLAEq4",
    "ResNetMRLABase",
    "ResNetMRLALight",
    "ViTBlock",
    "ViTMRLA",
    "VisionTransformer",
    "create_model",
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
