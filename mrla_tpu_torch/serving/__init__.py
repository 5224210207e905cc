from mrla_tpu_torch.serving.resnet_mrlal import (
    attach_stage4,
    prepare_inference_params,
    resnet_mrlal_forward,
)

__all__ = ["attach_stage4", "prepare_inference_params",
           "resnet_mrlal_forward"]
