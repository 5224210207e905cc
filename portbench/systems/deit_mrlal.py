"""deit_mrlal configurations: the port's DeiT serving engine
(``serving/deit.py``: weights cast once, the token-tail kernel), and the
plain reference ``reference/deit_mrlal.py``, which in float8 is also the
lower-precision control (the port has no such path of its own for
DeiT).  Training goes through the port's trainer (``loops/train_steps.py``).
"""

from __future__ import annotations

import importlib

import torch

from portbench.reference import deit_mrlal as reference
from portbench.reference.common import Precision
from portbench.work.flops import deit_mrlal as flops_per_image  # noqa: F401

ENTRY = ("mrla_tpu_torch.serving.deit", "deit_forward")


def serving(cfg: dict, traffic: dict, sd: dict, device, seed: int):
    """``forward(images) -> fp32 logits`` of the engine on the weights
    ``sd``."""
    engine = importlib.import_module(ENTRY[0])
    params = engine.prepare_deit_inference_params(
        cfg["arch"], sd, device=device, dtype=getattr(torch, traffic["dtype"]),
        img_size=cfg["image_size"], num_classes=cfg["num_classes"])
    kw = traffic.get("engine", {})
    return lambda x: getattr(engine, ENTRY[1])(params, x, **kw)


def control(cfg: dict, traffic: dict, sd: dict, device, seed: int):
    """The reference in float8 in the engine's place (the control of the
    correctness check; never in a benchmark run)."""
    q = Precision(fp8=True)
    return lambda x: reference.forward(sd, cfg, x, q)
