"""Detection trainer CLI: the port's counterpart of the JAX package's
``detect/train_cli.py`` (and of the reference's ``tools/train.py <config>``
MMDetection run), for RetinaNet and the two-stage presets.

The 1x recipe the presets inherit: SGD momentum 0.9, weight decay 1e-4
(``torch.optim.SGD(momentum, weight_decay, dampening=0)`` is optax's
``add_decayed_weights`` -> ``sgd(momentum)``), linear warmup over 500
iterations from ratio 1e-3, lr x0.1 at epochs 8 and 11 (in steps of the
real epoch: ``--steps-per-epoch`` on synthetic data, the train split's
batches on COCO), 12 epochs, base lr 0.02 for the two-stage presets and
0.01 for RetinaNet (retinanet_r50mrlal_fpn_1x_coco.py:6-7), scaled by
batch / 16.  The backbone's ``frozen_stages`` (1: stem and layer1) is
``requires_grad=False`` (``detect.backbone.freeze_stages``), and
``norm_eval`` keeps the model in eval mode, so BN uses its running
statistics (the presets' only train-mode behaviour); ``--no-norm-eval``
trains BN on batch statistics with the JAX package's running-variance rule
(``models/common.py:BatchNorm2d``).  ``--remat`` recomputes each backbone
block in the backward.  ``--bf16`` runs the step under ``torch.autocast``
(fp32 parameters, bf16 compute), as the Flax modules' ``dtype``; the
losses take their logits in fp32.

Data: ``--data synthetic-detect`` (the learnable squares task, square
images of ``--img-size``'s first value, masks for the mask preset) or
``--data coco`` with ``--train-ann`` / ``--train-imgs`` (and
``--val-ann`` / ``--val-imgs``; ``data/coco.py``) on an ``--img-size H W``
canvas, 800 x 1344 unless given.  Each epoch writes one JSON line to
``<output-dir>/log.jsonl`` (and prints it): the epoch's last losses, lr,
time and, every ``--eval-every`` epochs, the COCO-style mAP of the
validation data (``--eval-steps`` synthetic batches, or the whole val
split with a ragged last batch's padding rows skipped, boxes scored in
the original image's coordinates with its crowd regions), and
``<output-dir>/checkpoint.pt`` (``best.pt`` at a best mAP;
``ckpt/io.py``).  ``--resume <dir>`` continues at the epoch after its
checkpoint; ``--eval-only`` evaluates ``--resume`` (or the init) and
prints ``{"eval_only": true, ...}``.  ``--pretrained-backbone <dir>``
copies a classification run's trunk into the backbone;
``--torch <pth>`` loads a whole mmdet-keyed detector as it is.

Usage:
  python -m mrla_tpu_torch.detect.train_cli \\
      --preset retinanet_r50mrlal_fpn_1x_coco --data coco \\
      --train-ann instances_train2017.json --train-imgs train2017 \\
      --val-ann instances_val2017.json --val-imgs val2017 \\
      --batch-size 8 --output-dir runs/det

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
raises.  Not ported yet: ``--dp`` (multi-card) and ``--roi-backend`` (the
JAX package's TPU routing: here RoIAlign is the CUDA kernel on the card
and its plain version on the CPU).
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mrla_tpu_torch detection "
                                            "trainer")
    p.add_argument("--preset", default="faster_rcnn_r50mrlal_fpn_1x_coco",
                   choices=sorted(PRESETS))
    p.add_argument("--data", default="synthetic-detect",
                   choices=["synthetic-detect", "coco"])
    p.add_argument("--train-ann", default=None,
                   help="COCO instances json (train)")
    p.add_argument("--train-imgs", default=None)
    p.add_argument("--val-ann", default=None,
                   help="default: the train split")
    p.add_argument("--val-imgs", default=None)
    p.add_argument("--img-size", type=int, nargs="+", default=None,
                   help="canvas H [W]: default 800 1344 for coco, 256 for "
                        "synthetic data (square: the first value)")
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--max-gt", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=None,
                   help="default: preset (12)")
    p.add_argument("--steps-per-epoch", type=int, default=50,
                   help="synthetic data only")
    p.add_argument("--lr", type=float, default=None,
                   help="default: preset base lr (0.02; retinanet 0.01) "
                        "scaled by batch / 16")
    p.add_argument("--warmup-iters", type=int, default=500)
    p.add_argument("--warmup-ratio", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--frozen-stages", type=int, default=None,
                   help="default: preset (1); -1 freezes nothing")
    p.add_argument("--no-norm-eval", action="store_true",
                   help="update backbone BN statistics (presets freeze "
                        "them)")
    p.add_argument("--backbone-layers", type=int, nargs=4, default=None,
                   help="override the preset's depth (tests use 1 1 1 1)")
    p.add_argument("--rpn-proposals", type=int, default=1000)
    p.add_argument("--rcnn-samples", type=int, default=512)
    p.add_argument("--pretrained-backbone", default=None,
                   help="classification run dir (its checkpoint.pt) whose "
                        "trunk initialises the backbone")
    p.add_argument("--torch", default=None,
                   help="mmdet-keyed detector .pth to load as it is (pair "
                        "with --eval-only for the runbook's mAP check)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute under torch.autocast (fp32 params)")
    p.add_argument("--remat", action="store_true",
                   help="recompute backbone blocks in the backward")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="runs/detect")
    p.add_argument("--resume", default=None,
                   help="run dir whose checkpoint.pt to continue from")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: restore --resume (or the init) "
                        "and report mAP")
    p.add_argument("--eval-every", type=int, default=1,
                   help="epochs between mAP evals; 0 disables")
    p.add_argument("--eval-steps", type=int, default=8,
                   help="synthetic validation batches per eval")
    p.add_argument("--score-thr", type=float, default=0.05)
    p.add_argument("--roi-sampling-ratio", type=int, default=0,
                   help="two-stage RoIAlign grid: 0 = the presets' "
                        "adaptive grid (exact, at no extra cost to the "
                        "kernel), k > 0 = static k x k")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def canvas_hw(args) -> tuple:
    if args.img_size is None:
        return (800, 1344) if args.data == "coco" else (256, 256)
    s = args.img_size
    return (s[0], s[1]) if len(s) == 2 else (s[0], s[0])


def model_kind(preset: str) -> str:
    return "retinanet" if preset.startswith("retinanet") else "two_stage"


def build_model(args, device) -> torch.nn.Module:
    """The preset's detector from ``--seed``, on ``device``, in train mode
    with ``--no-norm-eval`` and in eval mode (BN on its running
    statistics) otherwise."""
    from mrla_tpu_torch.detect.retinanet import RetinaNet
    from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN

    preset = PRESETS[args.preset]
    layers = tuple(args.backbone_layers or preset.backbone_layers)
    gen = torch.Generator().manual_seed(args.seed)
    if model_kind(args.preset) == "retinanet":
        model = RetinaNet(layers=layers, num_classes=args.num_classes,
                          remat=args.remat, generator=gen)
    else:
        cls = MaskRCNN if preset.with_mask else FasterRCNN
        model = cls(layers=layers, num_classes=args.num_classes,
                    num_proposals=args.rpn_proposals,
                    roi_sampling_ratio=args.roi_sampling_ratio,
                    remat=args.remat, generator=gen)
    return model.to(device).train(not preset.norm_eval or args.no_norm_eval)


def make_schedule(args, preset, steps_per_epoch: int):
    """(lr of a step, epochs): linear warmup from ``warmup_ratio``, then
    x0.1 at each milestone epoch."""
    base = args.lr
    if base is None:
        base = (0.01 if model_kind(preset.name) == "retinanet"
                else 0.02) * args.batch_size / 16.0
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


def coco_split(args, train: bool):
    from mrla_tpu_torch.data.coco import CocoDetection

    ann = args.train_ann if train else (args.val_ann or args.train_ann)
    imgs = args.train_imgs if train else (args.val_imgs or args.train_imgs)
    if ann is None or imgs is None:
        raise SystemExit("--data coco requires --train-ann/--train-imgs")
    return CocoDetection(ann, imgs)


def steps_per_epoch(args) -> int:
    """The real epoch's length on COCO (the schedule's milestones are in
    epochs); ``--steps-per-epoch`` on synthetic data."""
    if args.data == "coco":
        n = len(coco_split(args, train=True))
        return max(1, -(-n // args.batch_size))
    return args.steps_per_epoch


def data_iter(args, train: bool, epoch: int):
    """The numpy batches of one epoch, or of one evaluation (COCO's with
    the eval extras)."""
    canvas = canvas_hw(args)
    with_masks = PRESETS[args.preset].with_mask
    if args.data == "synthetic-detect":
        from mrla_tpu_torch.data.synthetic import synthetic_detection_batches

        return synthetic_detection_batches(
            args.batch_size, image_size=canvas[0],
            num_classes=args.num_classes,
            steps=args.steps_per_epoch if train else args.eval_steps,
            max_gt=args.max_gt,
            seed=args.seed + epoch * 1000 + (0 if train else 777),
            with_masks=with_masks)
    from mrla_tpu_torch.data.coco import coco_batches

    return coco_batches(coco_split(args, train), args.batch_size,
                        canvas_hw=canvas, max_gt=args.max_gt, shuffle=train,
                        augment=train, seed=args.seed + epoch,
                        with_masks=with_masks, with_eval_extras=not train)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k != "sample_valid"}


def train_step(model, opt, batch, rand, args) -> Dict[str, torch.Tensor]:
    """One SGD step on ``batch`` (device tensors); returns the loss terms."""
    with torch.autocast(batch["image"].device.type, dtype=torch.bfloat16,
                        enabled=args.bf16):
        if model_kind(args.preset) == "retinanet":
            from mrla_tpu_torch.detect.losses import retinanet_loss

            losses = retinanet_loss(model(batch["image"]), batch["gt_boxes"],
                                    batch["gt_labels"], batch["gt_valid"],
                                    num_classes=args.num_classes)
            total = losses["loss"]
        else:
            from mrla_tpu_torch.detect.two_stage_train import (
                faster_rcnn_train_loss,
            )

            total, losses, _ = faster_rcnn_train_loss(
                model, batch["image"], batch["gt_boxes"],
                batch["gt_labels"], batch["gt_valid"], rand,
                gt_masks=batch.get("gt_masks"), rcnn_num=args.rcnn_samples)
    opt.zero_grad(set_to_none=True)
    total.backward()
    opt.step()
    return {k: v.detach() for k, v in losses.items()}


def load_weights(args, model) -> None:
    """``--pretrained-backbone`` and ``--torch``, in that order."""
    if args.pretrained_backbone:
        from mrla_tpu_torch.ckpt.io import read_model_state_dict
        from mrla_tpu_torch.detect.backbone import (
            load_backbone_from_classification,
        )

        sd = read_model_state_dict(args.pretrained_backbone)
        if sd is None:
            raise SystemExit(f"no checkpoint at {args.pretrained_backbone}")
        load_backbone_from_classification(model, sd)
        print(f"loaded backbone from {args.pretrained_backbone}")
    if args.torch:
        sd = torch.load(args.torch, map_location="cpu")
        sd = sd.get("state_dict", sd)
        model.load_state_dict({k.removeprefix("module."): v
                               for k, v in sd.items()})
        print(f"loaded detector weights from {args.torch}")


def main(argv=None) -> Dict[str, Any]:
    """Train (or with ``--eval-only`` evaluate); returns the model, the best
    mAP, the last step's losses, and of each step its total loss and host
    seconds (data, then the step up to its loss on the host)."""
    from mrla_tpu_torch.ckpt.io import restore_checkpoint, save_checkpoint
    from mrla_tpu_torch.train.state import TrainState

    args = parse_args(argv)
    device = resolve_device(args.device)
    preset = PRESETS[args.preset]
    model = build_model(args, device)
    load_weights(args, model)
    spe = steps_per_epoch(args)
    schedule, epochs = make_schedule(args, preset, spe)
    opt = make_optimizer(args, model, schedule)
    state = TrainState(model, opt, schedule)

    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "log.jsonl")
    start_epoch, best_map = 0, -1.0
    if args.resume:
        restored = restore_checkpoint(args.resume, state)
        if restored is not None:
            _, start_epoch, best_map = restored
            start_epoch += 1
            print(f"resumed epoch {start_epoch} (best mAP {best_map:.4f})")

    if args.eval_only:
        m = evaluate(args, model, start_epoch, device)
        print(json.dumps({"eval_only": True, **m}), flush=True)
        return {"model": model, "best_map": m["mAP"], **m}

    global_step = start_epoch * spe
    losses: Dict[str, torch.Tensor] = {}
    data_s, step_s, step_loss = [], [], []
    for epoch in range(start_epoch, epochs):
        # the samplers' draws restart each epoch, so a resumed run draws
        # what an unbroken one does
        rand = torch.Generator(device=device).manual_seed(
            args.seed + 1 + epoch)
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
        is_best = False
        if args.eval_every and (epoch + 1) % args.eval_every == 0:
            m = evaluate(args, model, epoch, device)
            line.update(m)
            is_best = m["mAP"] > best_map
            best_map = max(best_map, m["mAP"])
        state.step = global_step
        save_checkpoint(args.output_dir, state, epoch, best_map,
                        is_best=is_best)
        with open(log_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return {"model": model, "best_map": best_map,
            "last_losses": {k: float(v) for k, v in losses.items()},
            "loss": step_loss, "data_s": data_s, "step_s": step_s}


@torch.inference_mode()
def predict(args, model, x: torch.Tensor) -> Dict[str, np.ndarray]:
    """Detections of a batch (and, for the mask preset, soft masks) as
    numpy: RetinaNet through ``get_bboxes``, the R-CNNs through
    ``two_stage_predict``."""
    from mrla_tpu_torch.detect.retinanet import get_bboxes
    from mrla_tpu_torch.detect.two_stage import two_stage_predict

    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=args.bf16):
        if model_kind(args.preset) == "retinanet":
            keys = ("det_boxes", "det_scores", "det_labels", "det_valid")
            res = dict(zip(keys, get_bboxes(
                model(x), (x.shape[1], x.shape[2]),
                score_thr=args.score_thr)))
        else:
            res = two_stage_predict(model, x, score_thr=args.score_thr)
    return {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in res.items()}


def evaluate(args, model, epoch: int, device) -> Dict[str, Any]:
    """COCO-style mAP (and mask mAP for the mask preset) over the
    validation batches, in eval mode; rows whose ``sample_valid`` is false
    (a ragged last batch's padding) are skipped."""
    from mrla_tpu_torch.detect.coco_eval import (
        evaluate_detections,
        paste_masks,
    )

    training = model.training
    model.eval()
    preds, gts, preds_m, gts_m = [], [], [], []
    try:
        for batch in data_iter(args, train=False, epoch=epoch):
            x = torch.from_numpy(batch["image"]).to(device)
            res = predict(args, model, x)
            for b in range(x.shape[0]):
                if not bool(batch["sample_valid"][b]):
                    continue
                m = res["det_valid"][b]
                gv = batch["gt_valid"][b]
                boxes = res["det_boxes"][b][m]
                # the bbox protocol runs in the original image's
                # coordinates, with the json areas and crowd regions where
                # the loader gives them
                sc = float(batch["scale"][b]) if "scale" in batch else 1.0
                preds.append({"boxes": boxes / sc,
                              "scores": res["det_scores"][b][m],
                              "labels": res["det_labels"][b][m]})
                gt = {"boxes": batch["gt_boxes"][b][gv] / sc,
                      "labels": batch["gt_labels"][b][gv]}
                if "gt_areas" in batch:
                    gt["areas"] = batch["gt_areas"][b][gv]
                if "crowd_valid" in batch and batch["crowd_valid"].shape[1]:
                    cv = batch["crowd_valid"][b]
                    gt["iscrowd"] = np.concatenate(
                        [np.zeros(int(gv.sum()), bool), cv[cv]])
                    for k in ("boxes", "labels", "areas"):
                        if k in gt:
                            gt[k] = np.concatenate(
                                [gt[k], batch[f"crowd_{k}"][b][cv]])
                gts.append(gt)
                if "masks" in res and "gt_masks" in batch:
                    # the segm protocol stays in canvas space, over the
                    # non-crowd instances
                    preds_m.append({
                        "boxes": boxes, "scores": res["det_scores"][b][m],
                        "labels": res["det_labels"][b][m],
                        "masks": paste_masks(res["masks"][b][m], boxes,
                                             (x.shape[1], x.shape[2]))})
                    gts_m.append({"boxes": batch["gt_boxes"][b][gv],
                                  "labels": batch["gt_labels"][b][gv],
                                  "masks": batch["gt_masks"][b][gv] >= 0.5})
    finally:
        model.train(training)
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
    out["val_count"] = len(gts)
    return out


if __name__ == "__main__":
    main()
