from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    depthwise_conv3x3,
    eca_kernel_size,
    global_avg_pool,
    max_pool_same_torch,
)
from mrla_tpu_torch.ops.mrla import MRLAParams, mrla_light_attention

__all__ = [
    "MRLAParams",
    "channel_conv1d",
    "depthwise_conv3x3",
    "eca_kernel_size",
    "global_avg_pool",
    "max_pool_same_torch",
    "mrla_light_attention",
]
