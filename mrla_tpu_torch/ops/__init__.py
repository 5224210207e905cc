from mrla_tpu_torch.ops.channel_gates import eca_gate, se_gate
from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    depthwise_conv3x3,
    eca_kernel_size,
    global_avg_pool,
    max_pool_same_torch,
)
from mrla_tpu_torch.ops.drop import drop_path, dropout
from mrla_tpu_torch.ops.linear_la import (
    elu_feature_map,
    linear_cla_step,
    linear_gla_step,
    linear_la_step,
    svd_compress,
    svd_reconstruct,
)
from mrla_tpu_torch.ops.mrla import (
    MRLACache,
    MRLAParams,
    cache_buffers,
    la_eq4_attention,
    mrla_base_attention,
    mrla_base_attention_fixed,
    mrla_light_attention,
)

__all__ = [
    "MRLACache",
    "MRLAParams",
    "cache_buffers",
    "channel_conv1d",
    "depthwise_conv3x3",
    "drop_path",
    "dropout",
    "eca_gate",
    "eca_kernel_size",
    "elu_feature_map",
    "global_avg_pool",
    "la_eq4_attention",
    "linear_cla_step",
    "linear_gla_step",
    "linear_la_step",
    "max_pool_same_torch",
    "mrla_base_attention",
    "mrla_base_attention_fixed",
    "mrla_light_attention",
    "se_gate",
    "svd_compress",
    "svd_reconstruct",
]
