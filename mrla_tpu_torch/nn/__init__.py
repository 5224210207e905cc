from mrla_tpu_torch.nn.layers import (
    LALayer,
    MRLABaseLayer,
    MRLABaseModule,
    MRLALightLayer,
    MRLALightModule,
)

__all__ = ["LALayer", "MRLABaseLayer", "MRLABaseModule", "MRLALightLayer",
           "MRLALightModule"]
