from mrla_tpu_torch.ckpt.from_jax import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
