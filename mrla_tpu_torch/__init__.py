"""mrla_tpu_torch: the PyTorch / CUDA (H100) port of mrla_tpu.

The JAX package ``mrla_tpu`` stays the reference; this package imports
nothing from it and nothing of JAX.  Public functions take and return NHWC
tensors, as the JAX package's do.  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``, and raise when no card is
present.

Ported so far: the resnet_mrlal serving path (ops, MRLA-light layers, the
model, the BN-folded engine) with its three hand-written kernels, the MRLA
block epilogue, the mega-tail and the stage kernel of the ``use_stage4``
route; and the DeiT / DeiT-MRLA-light serving path (models, the cast-once
engine) with the token-tail kernel (``kernels/``, sources in ``csrc/``);
and two-stage detection serving (``detect/``, ``serving/detect.py``:
Faster / Mask R-CNN on the MRLA backbone + FPN) with the RoIAlign kernel.
"""

from mrla_tpu_torch import ckpt, detect, kernels, models, nn, ops, serving
from mrla_tpu_torch._device import resolve_device

__all__ = ["ckpt", "detect", "kernels", "models", "nn", "ops", "resolve_device",
           "serving"]
