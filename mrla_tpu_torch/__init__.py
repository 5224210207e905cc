"""mrla_tpu_torch: the PyTorch / CUDA (H100) port of mrla_tpu.

The JAX package ``mrla_tpu`` stays the reference; this package imports
nothing from it and nothing of JAX.  Public functions take and return NHWC
tensors, as the JAX package's do.  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``, and raise when no card is
present.

Ported so far, each path with hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``) for every TPU kernel it runs:

  * resnet_mrlal serving (ops, MRLA-light layers, the model, the BN-folded
    engine ``serving/resnet_mrlal.py``) with the MRLA block epilogue and the
    mega-tail, and the ``use_stage4`` route with the stage kernel;
  * its tail routes (``serving/tail_routes.py``), the counterpart of the JAX
    package's in-model tail harness, with the block tail from z, the HWBC
    block tail, the row tail and the HWBC copy;
  * DeiT / DeiT-MRLA-light serving (models, the cast-once engine) with the
    token-tail kernel;
  * two-stage detection serving (``detect/``, ``serving/detect.py``: Faster
    / Mask R-CNN on the MRLA backbone + FPN) with the RoIAlign kernel;
  * two-stage detection training (``detect/train_cli.py``, the synthetic
    source in ``data/``) with the RoIAlign backward kernel; RetinaNet
    (``detect/retinanet.py``, ``detect/losses.py``; no kernel of its own),
    COCO-format data (``data/coco.py``) and the trainer's checkpoints,
    ``--resume``, ``--eval-only``, ``--torch``, ``--pretrained-backbone``,
    ``--no-norm-eval`` and ``--remat``;
  * the MRLA-base family: the eq. 6 and LA (eq. 4) ops, the
    resnet50/101/152_mrlab, resnet50_mrlab22 and resnet50/101_la_eq4
    models, the eq. 6 serving engine ``serving/resnet_mrlab.py`` and the
    ``deit_mrlab_*`` archs in the DeiT engine.  The JAX package computes
    them in plain jax.numpy, with no TPU kernel, and so does the port, in
    plain PyTorch;
  * classification training on one card (``train/``, ``train/cli.py``):
    the train forwards of the resnet_mrlal and DeiT families (DropPath,
    dropout, BN on batch statistics with the JAX package's running
    variance, ``remat``), the fused train epilogue
    (``ops/fused_train.py``), the losses, schedules, optimizers, EMA,
    Mixup / CutMix and the synthetic source, and ``torch.save``
    checkpoints (``ckpt/io.py``); on real data, ImageFolder with its
    threaded loader (PIL, or the native C++ JPEG loader in
    ``data/native``), the samplers (repeated augmentation included),
    RandAugment, the CIFAR and iNat readers, and fine-tuning
    (``utils/finetune.py``).  The JAX training path reaches no TPU kernel,
    and the port's is plain PyTorch too;
  * data parallelism for both trainers (``parallel/``: torchrun's launch
    environment, NCCL on cards and gloo on the CPU, DDP, BN over the
    global batch, the detection trainer's ``--dp``); the mesh
    (``parallel/mesh.py``: named axes, a process group a slice), output-
    channel tensor parallelism (``parallel/sharding.py``), the DeiT GPipe
    schedule (``parallel/pipeline.py``), data-parallel serving
    (``serving/sharded.py``) and :func:`dryrun_multichip` (``dryrun.py``).

The serving entries take the JAX package's ``microbatch`` option (and
``shared_stem`` on the resnet_mrlal engine); the port serves unsplit by
default (``serving/microbatch.py`` says why).

:func:`entry` is the package's counterpart of the repository's
``__graft_entry__.entry()``.
"""

import torch

from mrla_tpu_torch import (
    ckpt,
    data,
    detect,
    kernels,
    models,
    nn,
    ops,
    parallel,
    serving,
    train,
    utils,
)
from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.dryrun import dryrun_multichip


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(*example_args)`` is a resnet50_mrlal
    serving forward in bf16 on ``device`` (the card unless the caller asks
    for the CPU), from seed-0 weights, on 8 zero images at 224 px, returning
    logits [8, 1000] fp32."""
    model = models.create_model("resnet50_mrlal", device="cpu",
                                generator=torch.Generator().manual_seed(0))
    params = serving.prepare_inference_params(model, dtype=torch.bfloat16,
                                              device=device)
    x = torch.zeros(8, 224, 224, 3, dtype=torch.bfloat16,
                    device=resolve_device(device))
    return serving.resnet_mrlal_forward, (params, x)


__all__ = ["ckpt", "data", "detect", "dryrun_multichip", "entry",
           "kernels", "models", "nn",
           "ops", "parallel", "resolve_device", "serving", "train"]
