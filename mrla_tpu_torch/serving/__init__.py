from mrla_tpu_torch.serving.deit import (
    deit_forward,
    prepare_deit_inference_params,
)
from mrla_tpu_torch.serving.precast import (
    precast_forward,
    prepare_precast_inference_params,
)
from mrla_tpu_torch.serving.detect import (
    detect_forward,
    prepare_detect_params,
    two_stage_detections,
)
from mrla_tpu_torch.serving.resnet_mrlab import (
    prepare_mrlab_inference_params,
    resnet_mrlab_forward,
)
from mrla_tpu_torch.serving.resnet_mrlal import (
    attach_stage4,
    prepare_inference_params,
    resnet_mrlal_forward,
)
from mrla_tpu_torch.serving.sharded import make_sharded_forward
from mrla_tpu_torch.serving.tail_routes import resnet_mrlal_tail_forward

__all__ = ["attach_stage4", "deit_forward", "detect_forward",
           "make_sharded_forward",
           "prepare_deit_inference_params", "prepare_detect_params",
           "precast_forward", "prepare_inference_params",
           "prepare_mrlab_inference_params",
           "prepare_precast_inference_params",
           "resnet_mrlab_forward", "resnet_mrlal_forward",
           "resnet_mrlal_tail_forward",
           "two_stage_detections"]
