"""Data sources and transforms of the port (numpy on the host, PyTorch on
the device)."""

from mrla_tpu_torch.data.synthetic import (
    synthetic_batches,
    synthetic_detection_batches,
)
from mrla_tpu_torch.data.transforms import (
    MixDraw,
    apply_mixup_cutmix,
    center_crop_resize,
    draw_erasing,
    draw_mixup_cutmix,
    eval_transform_params,
    mixup_cutmix,
    normalize,
    random_erasing,
    random_flip,
    random_resized_crop_params,
)

__all__ = ["MixDraw", "apply_mixup_cutmix", "center_crop_resize",
           "draw_erasing", "draw_mixup_cutmix", "eval_transform_params",
           "mixup_cutmix", "normalize", "random_erasing", "random_flip",
           "random_resized_crop_params", "synthetic_batches",
           "synthetic_detection_batches"]
