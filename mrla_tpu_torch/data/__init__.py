"""Data sources and transforms of the port (numpy on the host, PyTorch on
the device): the synthetic sources, ImageFolder with its threaded loader
(PIL or the native C++ JPEG decoder), the samplers, CIFAR and iNat
readers, COCO detection data, the transforms and RandAugment."""

from mrla_tpu_torch.data.cifar import CIFAR, iterate_cifar
from mrla_tpu_torch.data.imagefolder import (
    ImageFolder,
    choose_decoder,
    iterate_batches,
)
from mrla_tpu_torch.data.coco import CocoDetection, coco_batches
from mrla_tpu_torch.data.inat import INatDataset
from mrla_tpu_torch.data.randaugment import rand_augment
from mrla_tpu_torch.data.samplers import (
    distributed_indices,
    ra_sampler_indices,
)
from mrla_tpu_torch.data.synthetic import (
    synthetic_batches,
    synthetic_detection_batches,
)
from mrla_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
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

__all__ = ["CIFAR", "CocoDetection", "IMAGENET_MEAN", "IMAGENET_STD",
           "INatDataset", "coco_batches",
           "ImageFolder", "MixDraw", "apply_mixup_cutmix",
           "center_crop_resize", "choose_decoder", "distributed_indices",
           "draw_erasing", "draw_mixup_cutmix", "eval_transform_params",
           "iterate_batches", "iterate_cifar", "mixup_cutmix", "normalize",
           "ra_sampler_indices", "rand_augment", "random_erasing",
           "random_flip", "random_resized_crop_params", "synthetic_batches",
           "synthetic_detection_batches"]
