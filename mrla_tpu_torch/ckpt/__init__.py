from mrla_tpu_torch.ckpt.from_jax import (
    arch_state_dict_from_jax,
    converter_for,
    detector_state_dict_from_jax,
    efficientnet_state_dict_from_jax,
    mrlab_serving_params_from_jax,
    patchconvnet_state_dict_from_jax,
    quant_params_from_jax,
    resmlp_state_dict_from_jax,
    retinanet_state_dict_from_jax,
    serving_params_from_jax,
    state_dict_from_jax,
    tail_params_from_jax,
    vit_state_dict_from_jax,
)
from mrla_tpu_torch.ckpt.io import (
    read_model_state_dict,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["arch_state_dict_from_jax", "converter_for",
           "detector_state_dict_from_jax", "efficientnet_state_dict_from_jax",
           "mrlab_serving_params_from_jax",
           "patchconvnet_state_dict_from_jax", "quant_params_from_jax",
           "read_model_state_dict",
           "resmlp_state_dict_from_jax", "restore_checkpoint",
           "retinanet_state_dict_from_jax", "save_checkpoint",
           "serving_params_from_jax",
           "state_dict_from_jax", "tail_params_from_jax",
           "vit_state_dict_from_jax"]
