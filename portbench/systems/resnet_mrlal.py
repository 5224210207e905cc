"""resnet_mrlal configurations: the port's serving engine
(``serving/resnet_mrlal.py``: BN folded, bf16, the MRLA kernels), its int8
engine as the lower-precision control (``serving/quant.py``), and the
plain reference ``reference/resnet_mrlal.py``.  Training goes through the
port's trainer, which any family shares (``loops/train_steps.py``)."""

from __future__ import annotations

import importlib

import torch

from portbench.reference import init
from portbench.reference import resnet_mrlal as reference  # the loops read it
from portbench.work.flops import resnet_mrlal as flops_per_image  # noqa: F401

# the serving entry, called through its module at each request, so that a
# test can break it underneath
ENTRY = ("mrla_tpu_torch.serving.resnet_mrlal", "resnet_mrlal_forward")
CALIBRATION_IMAGES = 32


def serving(cfg: dict, traffic: dict, sd: dict, device, seed: int):
    """``forward(images) -> fp32 logits`` of the engine on the weights
    ``sd``."""
    layers, dim = tuple(cfg["layers"]), cfg["dim_perhead"]
    engine = importlib.import_module(ENTRY[0])
    params = engine.prepare_inference_params(
        sd, layers=layers, dtype=getattr(torch, traffic["dtype"]),
        device=device)
    kw = traffic.get("engine", {})
    return lambda x: getattr(engine, ENTRY[1])(params, x, layers, dim, **kw)


def control(cfg: dict, traffic: dict, sd: dict, device, seed: int):
    """The port's int8 engine in the engine's place, its activation scales
    calibrated on seeded images (the control of the correctness check;
    never in a benchmark run)."""
    layers, dim = tuple(cfg["layers"]), cfg["dim_perhead"]
    quant = importlib.import_module("mrla_tpu_torch.serving.quant")
    calib = init.images(init.seeded(seed, 91, device=device),
                        CALIBRATION_IMAGES, cfg["image_size"], device)
    qp = quant.prepare_quant_params(sd, calib, layers, dim, device=device)
    return lambda x: quant.resnet_mrlal_quant_forward(qp, x, layers, dim)
