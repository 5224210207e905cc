"""Classification trainer CLI: the port's counterpart of the JAX package's
``train/cli.py`` (one harness for the reference's ResNet and DeiT
trainers), on one card or data-parallel over several.

Recipes, by their flags: SGD with a step or cosine schedule, warm-up and
label smoothing (the ResNet recipe); AdamW with the timm no-decay groups,
cosine, EMA, Mixup / CutMix, repeated augmentation and distillation (the
DeiT recipe); RMSpropTF with exponential decay (the EfficientNet recipe).
``--bf16`` runs the forward under ``torch.autocast`` (fp32 parameters,
bf16 compute), as the Flax modules' ``dtype``; ``--remat`` recomputes each
resnet block in the backward; ``--fused-epilogue`` (the port's switch for
the JAX model's ``fused_epilogue=True``) runs each resnet_mrlal block's
tail as one autograd Function in training.

Data:
  * ``--data <dir>``: ImageFolder trees ``<dir>/train`` and ``<dir>/val``
    (``data/imagefolder.py``), decoded on the host by ``--workers``
    threads, by the native JPEG loader where it builds, every file is a
    JPEG and the recipe resamples bilinearly, else by PIL; the DeiT,
    ResMLP, PatchConvNet and EfficientNet recipes resample bicubically
    (timm's), the rest bilinearly (torchvision's).  A train batch is
    RandomResizedCrop on the host, then on the device normalised, flipped,
    randomly erased (``--random-erase``) and mixed (Mixup / CutMix).  The
    indices of an epoch are a seeded shuffle, or with ``--repeated-aug``
    the DeiT recipe's RASampler (each image three times, cut to a multiple
    of 256).  Validation runs over the whole val set, the last ragged
    batch padded and its padding masked, so every image counts once;
  * ``synthetic`` (noise) or ``synthetic-learnable`` (a template per
    class), already normalised: as in the JAX trainer they take Mixup /
    CutMix but neither the flip nor the erasing.

Every draw is seeded from ``--seed``: the model's init, the DropPath /
dropout masks (a device generator handed to every such module of the
constructed model, so an arch's own nonzero default rate gets its draws
whatever the flags say), the crops (the loader's per-batch seeds), the
flips, erasing boxes and noise and the Mixup / CutMix draws (host numpy,
one stream a step, which also seeds the device generator of the flips and
the noise) and fresh heads.

Artefacts in ``--output-dir``, the JAX trainer's: ``train_loss.txt``,
``val_acc1.txt``, ``val_acc5.txt`` ("epoch value" lines), ``log.txt``
(one JSON object an epoch), and ``checkpoint.pt`` / ``best.pt`` /
``epoch_<e>.pt`` (``ckpt/io.py``); ``--resume <dir>`` continues at the
epoch after the stored one, ``-e`` evaluates (the EMA when
``--ema-decay`` is set).  ``--finetune <dir>`` starts from that run's
model (its position embedding resampled to a new token grid, fresh heads
for a new class count; ``utils/finetune.py``), with a fresh optimizer and
the EMA copied from the fine-tuned model.  ``--teacher-resume <dir>``
loads the distillation teacher from that run's model.  Both raise
``FileNotFoundError`` without a checkpoint.  ``--profile-dir <dir>``
writes a ``torch.profiler`` Chrome trace of steps 5-14 of the first epoch
(CPU and CUDA activity), cut short where the epoch is.  ``--layers`` (the
port's, as the detection trainer's ``--backbone-layers``) cuts the depth
of a resnet_mrlal arch or of a baseline ResNet / ResNeXt arch (SE, ECA,
the dw ablation).  ``--drop-path`` goes to the timm-lineage families
(DeiT, ResMLP, PatchConvNet, EfficientNet) as ``drop_path_rate`` and to
the resnet families as ``drop_path``, as in the JAX trainer.

    python -m mrla_tpu_torch.train.cli -a resnet50_mrlal --data <dir> \\
        --epochs 90 --batch-size 256 --workers 8 --bf16

Data parallelism: started by ``torchrun --nproc-per-node N -m
mrla_tpu_torch.train.cli ...`` (its launch environment,
``parallel/launch.py``), each rank trains on ``cuda:LOCAL_RANK`` (NCCL) or,
with ``--device cpu``, on the CPU (gloo), its model in DDP.  As in the JAX
trainer, ``--batch-size`` is the global batch and must divide by the world;
a rank takes its contiguous rows of each synthetic global batch, or its
stride of the epoch's indices (the samplers' rank and world), with its
crops' and augmentation's seeds offset by its rank; BN normalises over the
global batch (``models/common.py:BatchNorm2d``); Mixup / CutMix mix within
the rank's rows, as the JAX trainer does across processes and the reference
per rank.  Validation takes each rank's stride of the val set, padded to
one length on every rank and masked, with the counts summed over the
ranks.  The logged loss is the mean over the ranks; checkpoints, ``*.txt``
and ``log.txt`` are rank 0's, and they hold the unwrapped model, so a run
resumes, fine-tunes and evaluates at any world size.

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.ckpt.io import (
    read_model_state_dict,
    restore_checkpoint,
    save_checkpoint,
)
from mrla_tpu_torch.data import native
from mrla_tpu_torch.data.imagefolder import (
    ImageFolder,
    choose_decoder,
    iterate_batches,
)
from mrla_tpu_torch.data.samplers import (
    distributed_indices,
    ra_sampler_indices,
)
from mrla_tpu_torch.data.synthetic import synthetic_batches
from mrla_tpu_torch.data.transforms import (
    mixup_cutmix,
    normalize,
    random_erasing,
    random_flip,
)
from mrla_tpu_torch.models import ResNetMRLALight, create_model, list_models
from mrla_tpu_torch.models import resnet as resnet_models
from mrla_tpu_torch.nn.layers import set_generator
from mrla_tpu_torch.parallel import (
    all_gather_metrics,
    data_parallel,
    global_mean,
    init_distributed,
    initialized,
    is_main_process,
    rank_device,
    shard_batch,
)
from mrla_tpu_torch.train.losses import (
    cross_entropy,
    label_smoothing_ce,
    soft_target_ce,
)
from mrla_tpu_torch.train.metrics import AverageMeter, data_save, jsonl_log
from mrla_tpu_torch.train.optim import adamw_timm, rmsprop_tf, sgd_torch
from mrla_tpu_torch.train.schedules import (
    cosine_with_warmup,
    exponential_decay_with_warmup,
    multistep_with_warmup,
    step_with_warmup,
)
from mrla_tpu_torch.train.state import create_train_state
from mrla_tpu_torch.train.steps import eval_step, train_step
from mrla_tpu_torch.utils.finetune import (
    interpolate_pos_embed,
    reset_classifier,
)

SYNTHETIC = ("synthetic", "synthetic-learnable")
RANK_SEED = 1_000_003  # a rank's offset of its crops', augmentation's and
# drop masks' seeds
TIMM_STYLE = ("deit", "resmlp", "patchconvnet", "efficientnet")
PROFILE_STEPS = (5, 15)  # the first epoch's steps [5, 15) are traced
TRACE_NAME = "trace.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mrla_tpu_torch trainer")
    p.add_argument("-a", "--arch", default="resnet50_mrlal",
                   choices=list_models())
    p.add_argument("--data", default="synthetic",
                   help="an ImageFolder root (<dir>/train, <dir>/val), "
                        "'synthetic' (noise) or 'synthetic-learnable' "
                        "(class templates)")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--synthetic-steps", type=int, default=20)
    # optimizer / schedule
    p.add_argument("--opt", default="sgd", choices=["sgd", "adamw",
                                                     "rmsproptf"])
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay", type=float,
                   default=1e-4)
    p.add_argument("--scheduler", default="step",
                   choices=["step", "cosine", "multistep", "exp"])
    p.add_argument("--warmup-epochs", type=int, default=3)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--lr-scale-512", action="store_true",
                   help="deit linear scaling: lr *= batch/512")
    # regularization
    p.add_argument("--label-smooth", type=float, default=0.0)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--cutmix", type=float, default=0.0)
    p.add_argument("--random-erase", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.0)
    p.add_argument("--drop-rate", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--repeated-aug", action="store_true")
    # distillation
    p.add_argument("--distillation-type", default="none",
                   choices=["none", "soft", "hard"])
    p.add_argument("--teacher-arch", default="resnet50",
                   choices=list_models())
    p.add_argument("--teacher-resume", default="",
                   help="a run's directory: the teacher's weights from its "
                        "checkpoint")
    p.add_argument("--distillation-alpha", type=float, default=0.5)
    p.add_argument("--distillation-tau", type=float, default=1.0)
    # run control
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--resume", default="")
    p.add_argument("--finetune", default="",
                   help="a run's directory: start from its model "
                        "(position embedding resampled to a new grid, "
                        "fresh heads for a new class count)")
    p.add_argument("--output-dir", default="./runs/default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8,
                   help="the ImageFolder loader's threads")
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute under torch.autocast (fp32 params)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each resnet block in the backward")
    p.add_argument("--fused-epilogue", action="store_true",
                   help="resnet_mrlal: each block's train tail as one "
                        "autograd Function (ops/fused_train.py)")
    p.add_argument("--layers", type=int, nargs=4, default=None,
                   help="a resnet_mrlal or baseline resnet / resnext arch "
                        "at this depth instead of its own (smoke runs and "
                        "tests use 1 1 1 1)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace of steps 5-14 "
                        "of the first epoch here")
    p.add_argument("--device", default="cuda")
    return p


def build_optimizer(args, model, steps_per_epoch: int):
    """(optimizer, schedule of the global step)."""
    lr = args.lr
    if args.lr_scale_512:
        lr = lr * args.batch_size / 512.0
    schedule = {
        "step": lambda: step_with_warmup(lr, steps_per_epoch,
                                         args.warmup_epochs),
        "cosine": lambda: cosine_with_warmup(
            lr, args.epochs, steps_per_epoch, args.warmup_epochs),
        "multistep": lambda: multistep_with_warmup(
            lr, steps_per_epoch, warmup_epochs=args.warmup_epochs),
        "exp": lambda: exponential_decay_with_warmup(
            lr, steps_per_epoch, warmup_epochs=args.warmup_epochs),
    }[args.scheduler]()
    if args.opt == "sgd":
        opt = sgd_torch(model.parameters(), schedule(0), args.momentum,
                        args.weight_decay)
    elif args.opt == "adamw":
        opt = adamw_timm(model, schedule(0), weight_decay=args.weight_decay)
    else:
        opt = rmsprop_tf(model.parameters(), schedule(0),
                         weight_decay=args.weight_decay)
    return opt, schedule


def build_model(args, device):
    """The arch from ``--seed`` on ``device``, with the flags' rates."""
    kw: Dict[str, Any] = dict(num_classes=args.num_classes)
    if args.drop_path:
        # the timm-lineage models name it drop_path_rate; the resnet
        # families take a flat drop_path
        kw["drop_path_rate" if args.arch.startswith(TIMM_STYLE)
           else "drop_path"] = args.drop_path
    if args.drop_rate:
        kw["drop_rate"] = args.drop_rate
    # supported by resnet_mrlal; another arch rejects the keyword loudly
    if args.remat:
        kw["remat"] = True
    if args.fused_epilogue:
        kw["fused_epilogue"] = True
    if args.arch.startswith(("deit", "resmlp")):  # sized for the patches
        kw["img_size"] = args.image_size
    gen = torch.Generator().manual_seed(args.seed)
    if args.layers:
        if hasattr(resnet_models, args.arch):  # the baseline families
            kw["layers"] = args.layers
        elif args.arch.endswith("_mrlal") and not args.arch.startswith(
                "deit"):
            return ResNetMRLALight(args.layers, generator=gen, **kw).to(
                device)
        else:
            raise SystemExit(f"--layers sets a resnet_mrlal or baseline "
                             f"resnet depth, not {args.arch}'s")
    return create_model(args.arch, device=device, generator=gen, **kw)




def load_finetune(args, model) -> None:
    """Load ``--finetune``'s model into ``model``: the position embedding
    resampled where the grid differs (2 extra tokens with a dist token,
    else 1), fresh heads where their shape differs, then the state_dict
    (BN statistics included) loaded as the reference loads it, not
    strictly."""
    src = read_model_state_dict(args.finetune)
    if src is None:
        raise FileNotFoundError(
            f"--finetune checkpoint not found: {args.finetune}")
    dst = model.state_dict()
    if "pos_embed" in src and src["pos_embed"].shape != dst[
            "pos_embed"].shape:
        extra = 2 if "dist_token" in dst else 1
        src["pos_embed"] = interpolate_pos_embed(
            src["pos_embed"], dst["pos_embed"].shape[1] - extra, extra)
    heads = [n for n in ("head", "head_dist") if f"{n}.weight" in src]
    if any(src[f"{n}.weight"].shape != dst[f"{n}.weight"].shape
           for n in heads):
        src = reset_classifier(src, args.num_classes,
                               torch.Generator().manual_seed(args.seed + 9))
    missing, unexpected = model.load_state_dict(src, strict=False)
    print(f"finetuning from {args.finetune}"
          + (f"; missing {missing}" if missing else "")
          + (f"; unexpected {unexpected}" if unexpected else ""))


def build_teacher(args, device):
    """The distillation teacher in eval mode: ``--teacher-resume``'s model,
    or (with a warning) a random init from ``--seed``."""
    teacher = create_model(
        args.teacher_arch, device=device, num_classes=args.num_classes,
        generator=torch.Generator().manual_seed(args.seed + 7))
    if args.teacher_resume:
        sd = read_model_state_dict(args.teacher_resume, map_location=device)
        if sd is None:
            raise FileNotFoundError(
                f"--teacher-resume checkpoint not found: "
                f"{args.teacher_resume}")
        teacher.load_state_dict(sd)
    else:
        print("warning: distillation with a RANDOM teacher (no "
              "--teacher-resume): only meaningful in tests", file=sys.stderr)
    return teacher.eval()


def start_profile(device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, directory: str) -> None:
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_NAME)
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``n``."""
    return np.pad(a, [(0, n - len(a))] + [(0, 0)] * (a.ndim - 1))


def main(argv=None) -> Dict[str, Any]:
    """Train (or, with ``-e``, evaluate); returns the best acc@1, the
    history of epochs, the last validation's count, the decoder of each
    real-data batch (train and val), the state and the teacher, and of each
    step its loss (the mean over the ranks) and host seconds: ``data_s``
    until the batch is on the device (the wait for the source's batch,
    which is the loader's wait on real data or the synthetic draw, then its
    copy and the augmentation's launches), ``step_s`` the step up to its
    loss on the host.  A process group that this call joins from the launch
    environment is left again on return."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before joining a group
    joined = not initialized()
    info = init_distributed(device=args.device)
    try:
        return _main(args, info)
    finally:
        if joined and initialized():
            torch.distributed.destroy_process_group()


def _main(args, info) -> Dict[str, Any]:
    rank, world = info["process_index"], info["process_count"]
    if args.batch_size % world:
        raise ValueError(f"global batch {args.batch_size} not divisible by "
                         f"{world} ranks")
    local_batch = args.batch_size // world
    device = rank_device(args.device)
    main_rank = is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    if world > 1:
        say(f"distributed: {info}")
    os.makedirs(args.output_dir, exist_ok=True)
    synthetic = args.data in SYNTHETIC
    learnable = args.data == "synthetic-learnable"
    interpolation = ("bicubic" if args.arch.startswith(TIMM_STYLE)
                     else "bilinear")
    if synthetic:
        steps_per_epoch = args.synthetic_steps
    else:
        train_ds = ImageFolder(os.path.join(args.data, "train"))
        val_ds = ImageFolder(os.path.join(args.data, "val"))
        steps_per_epoch = len(train_ds) // args.batch_size
        decoder = choose_decoder(train_ds, interpolation)
        why = ""
        if interpolation == "bilinear" and not native.available():
            why = f" (native loader: {native.build_error().splitlines()[0]})"
        say(f"data: {len(train_ds)} train, {len(val_ds)} val images, "
            f"{interpolation}, decoder {decoder}{why}")

    model = build_model(args, device)
    if args.finetune:
        load_finetune(args, model)
    optimizer, schedule = build_optimizer(args, model, steps_per_epoch)
    state = create_train_state(model, optimizer, schedule,
                               ema_decay=args.ema_decay)
    if initialized():
        state.ddp = data_parallel(model, device)
    drop_gen = torch.Generator(device=device)
    set_generator(model, drop_gen)
    aug_gen = torch.Generator(device=device)

    start_epoch, best_acc1 = 0, 0.0
    if args.resume:
        restored = restore_checkpoint(args.resume, state)
        if restored is not None:
            # the checkpoint holds the just-completed epoch
            state, last_epoch, best_acc1 = restored
            start_epoch = last_epoch + 1
            say(f"resumed from {args.resume} after epoch {last_epoch}")

    use_soft = args.mixup > 0 or args.cutmix > 0
    if use_soft:
        loss_fn = soft_target_ce
    elif args.label_smooth > 0:
        def loss_fn(logits, labels):
            return label_smoothing_ce(logits, labels, args.label_smooth)
    else:
        loss_fn = cross_entropy
    teacher = (build_teacher(args, device)
               if args.distillation_type != "none" else None)
    decoders = {"train": [], "val": []}

    def eval_batches():
        """(images, labels, valid) on the device: this rank's rows of the
        val set (the synthetic global batches' rows, or its stride of the
        val set padded to the same length on every rank)."""
        if synthetic:
            for b in synthetic_batches(args.batch_size, args.image_size,
                                       args.num_classes, 2, seed=123,
                                       learnable=learnable):
                b = shard_batch(b, rank, world)
                yield (torch.from_numpy(b["image"]).to(device),
                       torch.from_numpy(b["label"]).to(device), None)
            return
        idxs = np.arange(rank, len(val_ds), world)
        n = len(idxs)
        n_local = -(-len(val_ds) // world)  # the same on every rank
        idxs = np.concatenate([idxs, np.zeros(n_local - n, np.int64)])
        for i, b in enumerate(iterate_batches(
                val_ds, idxs, local_batch, args.image_size,
                train=False, num_threads=args.workers, drop_last=False,
                interpolation=interpolation)):
            decoders["val"].append(b["decoder"])
            valid = i * local_batch + np.arange(local_batch) < n
            yield (normalize(torch.from_numpy(
                       pad_rows(b["image"], local_batch)).to(device)),
                   torch.from_numpy(
                       pad_rows(b["label"], local_batch)).to(device),
                   torch.from_numpy(valid).to(device))

    def validate(epoch):
        sums = {"top1": 0, "top5": 0, "count": 0}
        for images, labels, valid in eval_batches():
            batch = {"image": images, "label": labels}
            if valid is not None:
                batch["valid"] = valid
            out = eval_step(state, batch, use_ema=args.ema_decay > 0,
                            bf16=args.bf16)
            for k in sums:
                sums[k] += int(out[k])
        sums = {k: int(v) for k, v in all_gather_metrics(sums).items()}
        count = sums["count"]
        acc1 = 100.0 * sums["top1"] / max(count, 1)
        acc5 = 100.0 * sums["top5"] / max(count, 1)
        say(f"epoch {epoch}: val acc@1 {acc1:.3f} acc@5 {acc5:.3f} "
            f"({count} images)")
        return acc1, acc5, count

    def train_batches(epoch):
        """This rank's batches: its rows of each synthetic global batch, or
        its stride of the epoch's indices."""
        if synthetic:
            return (shard_batch(b, rank, world) for b in synthetic_batches(
                args.batch_size, args.image_size, args.num_classes,
                steps_per_epoch, seed=args.seed + epoch,
                learnable=learnable))
        sampler = (ra_sampler_indices if args.repeated_aug
                   else distributed_indices)
        return iterate_batches(
            train_ds, sampler(len(train_ds), rank, world, epoch,
                              seed=args.seed),
            local_batch, args.image_size, train=True,
            seed=args.seed + epoch + RANK_SEED * rank,
            num_threads=args.workers, interpolation=interpolation)

    if args.evaluate:
        acc1, acc5, count = validate(start_epoch)
        return {"acc1": acc1, "acc5": acc5, "val_count": count,
                "decoders": decoders}

    history, step_loss, data_s, step_s = [], [], [], []
    val_count = 0
    for epoch in range(start_epoch, args.epochs):
        t0 = t1 = time.perf_counter()
        losses = AverageMeter("loss")
        drop_gen.manual_seed(args.seed + 1000 * (epoch + 1)
                             + RANK_SEED * rank)
        prof = None
        for i, b in enumerate(train_batches(epoch)):
            if args.profile_dir and epoch == start_epoch and main_rank:
                if i == PROFILE_STEPS[0]:
                    prof = start_profile(device)
                elif i == PROFILE_STEPS[1] and prof is not None:
                    stop_profile(prof, args.profile_dir)
                    prof = None
            rng = np.random.default_rng(
                [args.seed + 1 + RANK_SEED * rank,
                 epoch * steps_per_epoch + i])
            images = torch.from_numpy(b["image"]).to(device)
            labels = torch.from_numpy(b["label"]).to(device)
            if not synthetic:
                decoders["train"].append(b["decoder"])
                aug_gen.manual_seed(int(rng.integers(2 ** 62)))
                images = random_flip(normalize(images), aug_gen)
                if args.random_erase > 0:
                    images = random_erasing(rng, images, aug_gen,
                                            args.random_erase)
            if use_soft:
                images, labels = mixup_cutmix(
                    rng, images, labels, args.num_classes,
                    mixup_alpha=max(args.mixup, 1e-8),
                    cutmix_alpha=max(args.cutmix, 1e-8),
                    label_smoothing=args.label_smooth)
            t2 = time.perf_counter()  # the batch on the device
            metrics = train_step(
                state, {"image": images, "label": labels}, loss_fn,
                grad_clip_norm=args.clip_grad, teacher=teacher,
                distill_kind=args.distillation_type,
                distill_alpha=args.distillation_alpha,
                distill_tau=args.distillation_tau, bf16=args.bf16)
            loss = float(global_mean(metrics["loss"]))  # waits for the step
            data_s.append(t2 - t1)
            t1 = time.perf_counter()
            step_s.append(t1 - t2)
            step_loss.append(loss)
            losses.update(loss, len(b["label"]))
            if i % args.print_freq == 0:
                say(f"epoch {epoch} [{i}/{steps_per_epoch}] {losses}")
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at epoch {epoch}")
        if prof is not None:  # the epoch ended before the last traced step
            stop_profile(prof, args.profile_dir)

        acc1, acc5, val_count = validate(epoch)
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        if main_rank:
            save_checkpoint(args.output_dir, state, epoch, best_acc1,
                            is_best=is_best, keep_every=30)
            data_save(args.output_dir, "train_loss", epoch, losses.avg)
            data_save(args.output_dir, "val_acc1", epoch, acc1)
            data_save(args.output_dir, "val_acc5", epoch, acc5)
            jsonl_log(os.path.join(args.output_dir, "log.txt"), {
                "epoch": epoch, "train_loss": losses.avg, "test_acc1": acc1,
                "test_acc5": acc5, "best_acc1": best_acc1,
                "epoch_time_s": round(time.perf_counter() - t0, 1),
            })
        history.append({"epoch": epoch, "loss": losses.avg, "acc1": acc1})

    return {"best_acc1": best_acc1, "history": history, "loss": step_loss,
            "data_s": data_s, "step_s": step_s, "val_count": val_count,
            "decoders": decoders, "state": state, "teacher": teacher}


if __name__ == "__main__":
    main()
