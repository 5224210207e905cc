from mrla_tpu_torch.serving.resnet_mrlal import (
    prepare_inference_params,
    resnet_mrlal_forward,
)

__all__ = ["prepare_inference_params", "resnet_mrlal_forward"]
