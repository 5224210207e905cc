from mrla_tpu_torch.serving.deit import (
    deit_forward,
    prepare_deit_inference_params,
)
from mrla_tpu_torch.serving.resnet_mrlal import (
    attach_stage4,
    prepare_inference_params,
    resnet_mrlal_forward,
)

__all__ = ["attach_stage4", "deit_forward", "prepare_deit_inference_params",
           "prepare_inference_params", "resnet_mrlal_forward"]
