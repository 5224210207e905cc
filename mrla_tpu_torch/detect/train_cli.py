"""Detection trainer CLI for the two-stage presets: the port's counterpart of
the JAX package's ``detect/train_cli.py`` (and of the reference's
``tools/train.py <config>`` MMDetection run).

The 1x recipe the presets inherit: SGD momentum 0.9, weight decay 1e-4
(``torch.optim.SGD(momentum, weight_decay, dampening=0)`` is optax's
``add_decayed_weights`` -> ``sgd(momentum)``), linear warmup over 500
iterations from ratio 1e-3, lr x0.1 at epochs 8 and 11, 12 epochs, base lr
0.02 scaled by batch / 16.  The backbone's ``frozen_stages`` (1: stem and
layer1) is ``requires_grad=False`` (``detect.backbone.freeze_stages``), and
``norm_eval`` keeps the model in eval mode, so BN uses its running
statistics (the presets' only train-mode behaviour).  ``--bf16`` runs the
step under ``torch.autocast`` (fp32 parameters, bf16 compute), as the Flax
modules' ``dtype``.

Data: ``--data synthetic-detect`` (the learnable squares task, with masks
for the mask preset); images are square, ``--img-size`` on a side.  Each
epoch writes one JSON line to ``<output-dir>/log.jsonl`` (and prints it):
the epoch's last losses, lr, time and, every ``--eval-every`` epochs, the
COCO-style mAP of ``--eval-steps`` validation batches.

Usage:
  python -m mrla_tpu_torch.detect.train_cli \\
      --preset faster_rcnn_r50mrlal_fpn_1x_coco --data synthetic-detect \\
      --img-size 800 --batch-size 8 --num-classes 80 --epochs 1 \\
      --steps-per-epoch 10 --output-dir runs/det

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
raises.  Not ported yet: ``--no-norm-eval``, ``--remat``, ``--dp``,
checkpoints and ``--resume``, ``--pretrained-backbone``, ``--torch``,
``--eval-only``, COCO data and RetinaNet.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.detect.configs import PRESETS

TWO_STAGE = sorted(p for p in PRESETS if not p.startswith("retinanet"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mrla_tpu_torch detection "
                                            "trainer (two-stage presets)")
    p.add_argument("--preset", default="faster_rcnn_r50mrlal_fpn_1x_coco",
                   choices=sorted(PRESETS))
    p.add_argument("--data", default="synthetic-detect",
                   choices=["synthetic-detect"])
    p.add_argument("--img-size", type=int, nargs="+", default=[256],
                   help="canvas side (synthetic images are square: the "
                        "first value)")
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--max-gt", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=None,
                   help="default: preset (12)")
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--lr", type=float, default=None,
                   help="default: 0.02 scaled by batch / 16")
    p.add_argument("--warmup-iters", type=int, default=500)
    p.add_argument("--warmup-ratio", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--frozen-stages", type=int, default=None,
                   help="default: preset (1); -1 freezes nothing")
    p.add_argument("--backbone-layers", type=int, nargs=4, default=None,
                   help="override the preset's depth (tests use 1 1 1 1)")
    p.add_argument("--rpn-proposals", type=int, default=1000)
    p.add_argument("--rcnn-samples", type=int, default=512)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute under torch.autocast (fp32 params)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="runs/detect")
    p.add_argument("--eval-every", type=int, default=1,
                   help="epochs between mAP evals; 0 disables")
    p.add_argument("--eval-steps", type=int, default=8,
                   help="synthetic validation batches per eval")
    p.add_argument("--score-thr", type=float, default=0.05)
    p.add_argument("--roi-sampling-ratio", type=int, default=0,
                   help="RoIAlign grid: 0 = the presets' adaptive grid "
                        "(exact, at no extra cost to the kernel), k > 0 = "
                        "static k x k")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_model(args, device) -> torch.nn.Module:
    """The preset's detector from ``--seed``, on ``device``, in eval mode
    (``norm_eval``: BN on its running statistics)."""
    from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN

    if args.preset not in TWO_STAGE:
        raise SystemExit(f"{args.preset}: RetinaNet training is not ported "
                         f"yet (two-stage presets: {TWO_STAGE})")
    preset = PRESETS[args.preset]
    cls = MaskRCNN if preset.with_mask else FasterRCNN
    gen = torch.Generator().manual_seed(args.seed)
    model = cls(layers=tuple(args.backbone_layers or preset.backbone_layers),
                num_classes=args.num_classes,
                num_proposals=args.rpn_proposals,
                roi_sampling_ratio=args.roi_sampling_ratio, generator=gen)
    return model.to(device).eval()


def make_schedule(args, preset, steps_per_epoch: int):
    """(lr of a step, epochs): linear warmup from ``warmup_ratio``, then
    x0.1 at each milestone epoch."""
    base = args.lr
    if base is None:
        base = 0.02 * args.batch_size / 16.0
    epochs = args.epochs or preset.epochs
    milestones = [m * steps_per_epoch for m in preset.lr_step_epochs]
    warmup = args.warmup_iters

    def schedule(step: int) -> float:
        if step < warmup:
            return base * (args.warmup_ratio + (1 - args.warmup_ratio)
                           * min(step, warmup) / max(warmup, 1))
        return base * 0.1 ** sum(step >= m for m in milestones)

    return schedule, epochs


def make_optimizer(args, model, schedule) -> torch.optim.SGD:
    """SGD with momentum, the weight decay added to the gradient (optax's
    ``add_decayed_weights`` then ``sgd(momentum)``), over the parameters
    that ``frozen_stages`` leaves trainable; lr from ``schedule(0)``."""
    from mrla_tpu_torch.detect.backbone import freeze_stages

    preset = PRESETS[args.preset]
    frozen = (preset.frozen_stages if args.frozen_stages is None
              else args.frozen_stages)
    return torch.optim.SGD(freeze_stages(model, frozen), lr=schedule(0),
                           momentum=args.momentum, dampening=0.0,
                           weight_decay=args.weight_decay)


def data_iter(args, train: bool, epoch: int):
    """Synthetic batches (numpy) of one epoch, or of one evaluation."""
    from mrla_tpu_torch.data.synthetic import synthetic_detection_batches

    return synthetic_detection_batches(
        args.batch_size, image_size=args.img_size[0],
        num_classes=args.num_classes,
        steps=args.steps_per_epoch if train else args.eval_steps,
        max_gt=args.max_gt,
        seed=args.seed + epoch * 1000 + (0 if train else 777),
        with_masks=PRESETS[args.preset].with_mask)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k != "sample_valid"}


def train_step(model, opt, batch, rand, args) -> Dict[str, torch.Tensor]:
    """One SGD step on ``batch`` (device tensors); returns the loss terms."""
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss

    with torch.autocast(batch["image"].device.type, dtype=torch.bfloat16,
                        enabled=args.bf16):
        total, losses, _ = faster_rcnn_train_loss(
            model, batch["image"], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_valid"], rand, gt_masks=batch.get("gt_masks"),
            rcnn_num=args.rcnn_samples)
    opt.zero_grad(set_to_none=True)
    total.backward()
    opt.step()
    return {k: v.detach() for k, v in losses.items()}


def main(argv=None) -> Dict[str, Any]:
    """Train; returns the model, the best mAP, the last step's losses, and
    of each step its total loss and host seconds (data, then the step up to
    its loss on the host)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    preset = PRESETS[args.preset]
    model = build_model(args, device)
    schedule, epochs = make_schedule(args, preset, args.steps_per_epoch)
    opt = make_optimizer(args, model, schedule)
    rand = torch.Generator(device=device).manual_seed(args.seed + 1)

    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "log.jsonl")
    global_step, best_map = 0, -1.0
    losses: Dict[str, torch.Tensor] = {}
    data_s, step_s, step_loss = [], [], []
    for epoch in range(epochs):
        t0 = t1 = time.perf_counter()
        for batch in data_iter(args, train=True, epoch=epoch):
            batch = to_device(batch, device)
            t2 = time.perf_counter()
            for group in opt.param_groups:
                group["lr"] = schedule(global_step)
            losses = train_step(model, opt, batch, rand, args)
            global_step += 1
            loss = float(losses["loss"])  # waits for the step
            data_s.append(t2 - t1)
            t1 = time.perf_counter()
            step_s.append(t1 - t2)
            step_loss.append(loss)
            if not np.isfinite(loss):
                raise SystemExit(f"non-finite loss at step {global_step}: "
                                 "abort")
        line = {"epoch": epoch, "step": global_step,
                "lr": schedule(global_step),
                "time_s": round(time.perf_counter() - t0, 2),
                **{k: float(v) for k, v in losses.items()}}
        if args.eval_every and (epoch + 1) % args.eval_every == 0:
            m = evaluate(args, model, epoch, device)
            line.update(m)
            best_map = max(best_map, m["mAP"])
        with open(log_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return {"model": model, "best_map": best_map,
            "last_losses": {k: float(v) for k, v in losses.items()},
            "loss": step_loss, "data_s": data_s, "step_s": step_s}


def evaluate(args, model, epoch: int, device) -> Dict[str, Any]:
    """COCO-style mAP (and mask mAP for the mask preset) over the
    synthetic validation batches, through ``two_stage_predict``."""
    from mrla_tpu_torch.detect.coco_eval import (
        evaluate_detections,
        paste_masks,
    )
    from mrla_tpu_torch.detect.two_stage import two_stage_predict

    preds, gts, preds_m, gts_m = [], [], [], []
    for batch in data_iter(args, train=False, epoch=epoch):
        x = torch.from_numpy(batch["image"]).to(device)
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=args.bf16):
            res = two_stage_predict(model, x, score_thr=args.score_thr)
        res = {k: v.float().cpu().numpy() if v.is_floating_point()
               else v.cpu().numpy() for k, v in res.items()}
        for b in range(x.shape[0]):
            m = res["det_valid"][b]
            gv = batch["gt_valid"][b]
            boxes = res["det_boxes"][b][m]
            preds.append({"boxes": boxes, "scores": res["det_scores"][b][m],
                          "labels": res["det_labels"][b][m]})
            gts.append({"boxes": batch["gt_boxes"][b][gv],
                        "labels": batch["gt_labels"][b][gv]})
            if "masks" in res:
                preds_m.append({**preds[-1], "masks": paste_masks(
                    res["masks"][b][m], boxes, (x.shape[1], x.shape[2]))})
                gts_m.append({**gts[-1],
                              "masks": batch["gt_masks"][b][gv] >= 0.5})
    res = evaluate_detections(preds, gts, num_classes=args.num_classes)
    out = {k: res[k] for k in ("mAP", "AP50", "AP75", "mAP_s", "mAP_m",
                               "mAP_l", "AR@1", "AR@10", "AR@100", "AR_s",
                               "AR_m", "AR_l")}
    if preds_m:
        segm = evaluate_detections(preds_m, gts_m,
                                   num_classes=args.num_classes,
                                   iou_kind="segm")
        out.update({"mask_mAP": segm["mAP"], "mask_AP50": segm["AP50"],
                    "mask_AP75": segm["AP75"]})
    return out


if __name__ == "__main__":
    main()
