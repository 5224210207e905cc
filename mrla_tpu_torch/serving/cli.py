"""Eval CLI through the serving engines: the port's counterpart of the JAX
package's ``serving/cli.py`` (the reference's eval mode, ``resnet/train.py
-e`` :284-289 -> validate :433).

    python -m mrla_tpu_torch.serving.cli -a resnet50_mrlal --data /imagenet \\
        [--torch r50_mrlal_77.75.pth.tar | --resume runs/x] [-b 128] \\
        [--quant int8] [--device cuda]

Routes the arch to its engine (the BN-folded mrlal engine, the mrlab cache
engine, or "precast": the DeiT engine for the ``deit*`` archs, the generic
cast-once engine for every other family), streams the val split through
the threaded ImageFolder loader, pads the ragged final batch and masks the
padding, and prints top-1 / top-5 and the engine's throughput as one JSON
line.  ``--torch`` reads a reference checkpoint (the port's modules carry
its key names), ``--resume`` a run directory of the port's trainers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.models import VisionTransformer, create_model


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mrla_tpu_torch serving eval")
    p.add_argument("-a", "--arch", default="resnet50_mrlal")
    p.add_argument("--data", required=True,
                   help="dataset root containing val/ (ImageFolder)")
    p.add_argument("--torch", default=None,
                   help="reference .pth.tar checkpoint (its state_dict "
                        "under 'state_dict' or 'model' or bare)")
    p.add_argument("--resume", default=None,
                   help="run dir of the port's trainers (reads its best.pt, "
                        "else checkpoint.pt)")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--quant", default="none",
                   choices=("none", "int8", "int8-fast"),
                   help="post-training-quantized engine (mrlal only; "
                        "calibrates on the first eval batch).  int8: "
                        "accuracy-safe bf16-residual form; int8-fast: "
                        "int8 residual carry (measurably LOSSY)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "mrlal", "mrlab", "precast"])
    p.add_argument("--microbatch", type=int, default=None,
                   help="override the engine's microbatch-chain size")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N images (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="the card by default; 'cpu' runs the kernels' "
                        "plain versions")
    return p


def _precast_microbatch_default(arch: str) -> dict:
    """Engine kwargs for the precast route when the user gave no
    --microbatch: the JAX package's rule (chains only for the DeiTs, whose
    engine then keeps its own default; every other arch unsplit)."""
    return {} if arch.startswith("deit") else {"microbatch": 0}


def _pick_engine(arch: str) -> str:
    if arch.startswith("resnet") and arch.endswith("_mrlal"):
        return "mrlal"
    if arch.startswith("resnet") and "_mrlab" in arch:
        return "mrlab"
    return "precast"


def _load_variables(args, model) -> Mapping[str, torch.Tensor]:
    """The weights to serve, as a state_dict: ``--torch``'s (nested under
    ``state_dict`` or ``model``, a ``module.`` prefix stripped),
    ``--resume``'s, or the model's own random ones."""
    if args.torch:
        sd = torch.load(args.torch, map_location="cpu", weights_only=True)
        if isinstance(sd, dict):
            sd = sd.get("state_dict", sd.get("model", sd))
        return {k.removeprefix("module."): v for k, v in sd.items()}
    if args.resume:
        from mrla_tpu_torch.ckpt.io import read_model_state_dict

        for name in ("best", "checkpoint"):
            sd = read_model_state_dict(args.resume, name)
            if sd is not None:
                return sd
        raise FileNotFoundError(f"no checkpoint under {args.resume}")
    print("warning: no --torch/--resume given, evaluating RANDOM weights",
          file=sys.stderr)
    return model.state_dict()


def make_engine_forward(
    arch: str,
    model,
    weights: Optional[Mapping[str, torch.Tensor]],
    engine: str = "auto",
    microbatch: Optional[int] = None,
    num_classes: int = 1000,
    quant: str = "none",
    calib_x=None,
    device="cuda",
):
    """Route ``arch`` to its serving engine and return ``fwd(x)``: [B, H,
    W, 3] images on ``device`` -> fp32 logits, over the prepared params
    (``weights``, a state_dict of ``model``; None serves the model's own).
    Shared by the eval CLI and the batching daemon.

    ``quant='int8'`` / ``'int8-fast'`` (mrlal engine only) swaps in the
    PTQ engine (``serving/quant.py``) calibrated on ``calib_x``."""
    del num_classes  # the model carries it; kept for the JAX signature
    engine = engine if engine != "auto" else _pick_engine(arch)
    mb_kw = {} if microbatch is None else {"microbatch": microbatch}
    if quant != "none":
        if quant not in ("int8", "int8-fast"):
            raise ValueError(f"unknown quant mode {quant!r}")
        if engine != "mrlal":
            raise ValueError(
                f"--quant {quant} supports the mrlal engine only, got {engine}"
            )
        if calib_x is None:
            raise ValueError(f"--quant {quant} needs a calibration batch")
    src = model if weights is None else weights
    if quant != "none":
        from mrla_tpu_torch.serving.quant import (
            prepare_quant_params,
            resnet_mrlal_quant_forward,
        )

        layers = tuple(model.layers)
        qp = prepare_quant_params(src, calib_x, layers=layers, device=device)
        qmb = {"microbatch": 64, **mb_kw}  # chains of 64, as in JAX
        return lambda x: resnet_mrlal_quant_forward(
            qp, x, layers=layers, quant_residual=quant == "int8-fast", **qmb)
    if engine == "mrlal":
        from mrla_tpu_torch.serving import (
            prepare_inference_params,
            resnet_mrlal_forward,
        )

        # depth from the constructed model; the prepare checks it against
        # the weights
        layers = tuple(model.layers)
        sp = prepare_inference_params(src, layers=layers, device=device)
        return lambda x: resnet_mrlal_forward(sp, x, layers=layers, **mb_kw)
    if engine == "mrlab":
        from mrla_tpu_torch.serving import (
            prepare_mrlab_inference_params,
            resnet_mrlab_forward,
        )

        layers = tuple(model.layers)
        sp = prepare_mrlab_inference_params(
            src, layers=layers, deep_stem=bool(model.deep_stem),
            device=device)
        relu_on_attn = bool(model.relu_on_attn)
        return lambda x: resnet_mrlab_forward(
            sp, x, layers=layers, relu_on_attn=relu_on_attn, **mb_kw)
    if microbatch is None:
        mb_kw = _precast_microbatch_default(arch)
    if isinstance(model, VisionTransformer):
        # every deit_* arch, deit_mrlal_* with the token-tail kernel
        from mrla_tpu_torch.serving import (
            deit_forward,
            prepare_deit_inference_params,
        )

        params = prepare_deit_inference_params(model, weights, device=device)
        return lambda x: deit_forward(params, x, **mb_kw)
    from mrla_tpu_torch.serving import (
        precast_forward,
        prepare_precast_inference_params,
    )

    served = prepare_precast_inference_params(model, weights, device=device)
    return lambda x: precast_forward(served, x, **mb_kw)


def _normalized(images: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A loader batch on ``dev``: uint8 normalised there, floats as they
    are."""
    from mrla_tpu_torch.data.transforms import normalize

    x = torch.from_numpy(images).to(dev)
    return normalize(x) if x.dtype == torch.uint8 else x


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)

    from mrla_tpu_torch.data.imagefolder import ImageFolder, iterate_batches

    model = create_model(args.arch, device="cpu",
                         num_classes=args.num_classes)
    weights = _load_variables(args, model)

    val_dir = os.path.join(args.data, "val")
    ds = ImageFolder(val_dir if os.path.isdir(val_dir) else args.data)

    calib_x = None
    if args.quant != "none":
        # calibrate the activation scales on the first batch of the data
        n_cal = min(len(ds), args.batch_size)
        for b in iterate_batches(ds, np.arange(n_cal), n_cal,
                                 args.image_size, train=False,
                                 num_threads=args.workers, drop_last=False):
            calib_x = _normalized(b["image"], dev)
            break

    fwd = make_engine_forward(
        args.arch, model, weights, engine=args.engine,
        microbatch=args.microbatch, num_classes=args.num_classes,
        quant=args.quant, calib_x=calib_x, device=dev,
    )

    idxs = np.arange(len(ds))
    if args.limit:
        idxs = idxs[: args.limit]
    n_valid = len(idxs)
    pad = (-len(idxs)) % args.batch_size
    idxs = np.concatenate([idxs, np.zeros(pad, np.int64)])

    # build and warm outside the timed region (the first call builds the
    # kernels and picks the library's algorithms)
    fwd(torch.zeros((args.batch_size, args.image_size, args.image_size, 3),
                    dtype=torch.bfloat16, device=dev)).cpu()

    top1 = top5 = seen = 0
    device_s = 0.0
    offset = 0
    for b in iterate_batches(ds, idxs, args.batch_size, args.image_size,
                             train=False, num_threads=args.workers,
                             drop_last=False):
        img = _normalized(b["image"], dev).to(torch.bfloat16)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the upload is not the engine's
        t0 = time.perf_counter()
        logits = fwd(img).cpu().numpy()  # the copy to the host syncs
        device_s += time.perf_counter() - t0
        labels = np.asarray(b["label"])
        valid = (offset + np.arange(len(labels))) < n_valid
        offset += len(labels)
        order = np.argsort(-logits, axis=-1)[:, :5]
        top1 += int(((order[:, 0] == labels) & valid).sum())
        top5 += int((np.any(order == labels[:, None], axis=1) & valid).sum())
        seen += int(valid.sum())

    result = {
        "arch": args.arch,
        "engine": (
            args.engine if args.engine != "auto" else _pick_engine(args.arch)
        ),
        "acc1": round(100.0 * top1 / max(seen, 1), 3),
        "acc5": round(100.0 * top5 / max(seen, 1), 3),
        "images": seen,
        "img_per_s_device": round(seen / max(device_s, 1e-9), 1),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
