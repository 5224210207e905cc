from mrla_tpu_torch.nn.layers import MRLALightLayer, MRLALightModule

__all__ = ["MRLALightLayer", "MRLALightModule"]
