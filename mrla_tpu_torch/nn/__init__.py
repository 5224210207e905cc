from mrla_tpu_torch.nn.layers import (
    DropPath,
    Dropout,
    ECALayer,
    LALayer,
    MRLABaseLayer,
    MRLABaseModule,
    MRLALightLayer,
    MRLALightModule,
    SELayer,
    set_generator,
)
from mrla_tpu_torch.nn.linear_la import (
    FEATURE_MAPS,
    LinearCLA,
    LinearGLA,
    LinearLayerAttention,
)

# The reference's mla_layer is the MRLA-light layer without the λ
# recurrence: the same module.
MLALayer = MRLALightLayer

__all__ = ["DropPath", "Dropout", "ECALayer", "FEATURE_MAPS", "LALayer",
           "LinearCLA", "LinearGLA", "LinearLayerAttention", "MLALayer",
           "MRLABaseLayer", "MRLABaseModule", "MRLALightLayer",
           "MRLALightModule", "SELayer", "set_generator"]
