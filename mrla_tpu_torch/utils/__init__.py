"""Utilities of the port: the fine-tuning surgery (``finetune.py``)."""

from mrla_tpu_torch.utils.finetune import (
    interpolate_pos_embed,
    reset_classifier,
)

__all__ = ["interpolate_pos_embed", "reset_classifier"]
