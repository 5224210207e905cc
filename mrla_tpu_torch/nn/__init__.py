from mrla_tpu_torch.nn.layers import (
    DropPath,
    Dropout,
    LALayer,
    MRLABaseLayer,
    MRLABaseModule,
    MRLALightLayer,
    MRLALightModule,
    set_generator,
)

__all__ = ["DropPath", "Dropout", "LALayer", "MRLABaseLayer",
           "MRLABaseModule", "MRLALightLayer", "MRLALightModule",
           "set_generator"]
