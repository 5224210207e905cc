from mrla_tpu_torch.models.deit import (
    Attention,
    Mlp,
    PatchEmbed,
    ViTBlock,
    VisionTransformer,
)
from mrla_tpu_torch.models.deit_mrla import (
    MRLALightTokenModule,
    MRLAViTBlock,
    ViTMRLA,
)
from mrla_tpu_torch.models.registry import create_model, list_models, register_model
from mrla_tpu_torch.models.resnet_mrla_light import (
    MRLABottleneck,
    ResNetMRLALight,
    resnet50_mrlal,
    resnet101_mrlal,
    resnet152_mrlal,
)

__all__ = [
    "Attention",
    "MRLABottleneck",
    "MRLALightTokenModule",
    "MRLAViTBlock",
    "Mlp",
    "PatchEmbed",
    "ResNetMRLALight",
    "ViTBlock",
    "ViTMRLA",
    "VisionTransformer",
    "create_model",
    "list_models",
    "register_model",
    "resnet50_mrlal",
    "resnet101_mrlal",
    "resnet152_mrlal",
]
