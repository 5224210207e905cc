from mrla_tpu_torch.ckpt.from_jax import (
    serving_params_from_jax,
    state_dict_from_jax,
    tail_params_from_jax,
    vit_state_dict_from_jax,
)

__all__ = ["serving_params_from_jax", "state_dict_from_jax",
           "tail_params_from_jax", "vit_state_dict_from_jax"]
