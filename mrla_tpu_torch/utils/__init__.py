"""Utilities of the port: parameter and FLOP accounting (``flops.py``),
the fine-tuning surgery (``finetune.py``) and the log tools
(``logtools.py``)."""

from mrla_tpu_torch.utils.finetune import (
    interpolate_pos_embed,
    reset_classifier,
)
from mrla_tpu_torch.utils.flops import count_flops, count_params, profile_model

__all__ = [
    "count_params",
    "count_flops",
    "profile_model",
    "interpolate_pos_embed",
    "reset_classifier",
]
