"""Parameter and FLOP accounting (the reference's thop wrappers,
resnet/paras_flops.py and deit/params_flops.py): the port's counterpart of
the JAX package's ``utils/flops.py``.

``count_flops`` counts with ``torch.utils.flop_counter.FlopCounterMode``
over one forward: matrix products, convolutions (depthwise and 1-D
included) and attention, two FLOPs a multiply-add.  The JAX function reads
XLA's cost analysis of the compiled forward, which differs in two ways:
it also counts the elementwise work (BatchNorm, activations, residual adds,
the MRLA gates, LayerNorm, softmax), and it counts only the taps of a
convolution's window that fall on the image, where ``FlopCounterMode``
counts the padded taps too.  So the port's figure lies between 0.8 and 1.1
of the JAX package's: above 1 for conv nets on small maps (a plain ResNet
at 64 px: 1.048), below where the elementwise work weighs (a two-block
DeiT at 64 px: 0.937, a narrower one at 32 px: 0.826); at 224 px the
padded taps are a smaller share.  ``tests/test_torch_utils.py`` holds the
band.

    python -m mrla_tpu_torch.utils.flops resnet50_mrlal deit_tiny_patch16_224
        [--image-size 224] [--device cuda]
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from mrla_tpu_torch._device import resolve_device

# state_dict entries that are BatchNorm statistics, not parameters
BN_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def count_params(model_or_state_dict: Union[nn.Module,
                                            Mapping[str, torch.Tensor]]
                 ) -> int:
    """The parameter count, as the JAX function counts
    ``variables["params"]``: a module's parameters, or a state_dict's
    entries less the BatchNorm statistics."""
    if isinstance(model_or_state_dict, nn.Module):
        return int(sum(p.numel() for p in model_or_state_dict.parameters()))
    return int(sum(v.numel() for k, v in model_or_state_dict.items()
                   if not k.endswith(BN_STATISTICS)))


def count_flops(model: nn.Module, input_shape=(1, 224, 224, 3),
                device="cuda") -> Optional[float]:
    """FLOPs of one eval-mode forward of NHWC zeros of ``input_shape`` on
    ``device`` (the model is moved there and left in the mode it was in)."""
    dev = resolve_device(device)
    model = model.to(dev)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            model(torch.zeros(input_shape, device=dev))
    finally:
        model.train(was_training)
    return float(fc.get_total_flops())


def profile_model(name: str, input_shape=(1, 224, 224, 3), device="cuda",
                  **model_kw) -> dict:
    """Build ``name`` from the registry and report its parameters and
    forward FLOPs, with the JAX function's keys."""
    from mrla_tpu_torch.models import create_model

    model = create_model(name, device=device, **model_kw)
    n_params = count_params(model)
    flops = count_flops(model, input_shape, device)
    return {
        "model": name,
        "params": n_params,
        "params_m": round(n_params / 1e6, 3),
        "flops": flops,
        # None (not counted) and NaN both -> None, as in the JAX function
        "gflops": (round(flops / 1e9, 3)
                   if flops is not None and flops == flops else None),
    }


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser("FLOPs/params profiler")
    p.add_argument("models", nargs="+")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    for name in args.models:
        print(json.dumps(profile_model(
            name, (1, args.image_size, args.image_size, 3),
            device=args.device)))
