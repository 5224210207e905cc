#!/usr/bin/env python3
"""Where the device time of one of the port's serving forwards goes.

    python3 -m mrla_tpu_torch.profile_serving [--use-stage4]
    python3 -m mrla_tpu_torch.profile_serving --arch deit_mrlal_small_patch16_224
    python3 -m mrla_tpu_torch.profile_serving --arch resnet50_mrlab [--use-scan]
    python3 -m mrla_tpu_torch.profile_serving --arch deit_mrlab_small_patch16_224
    python3 -m mrla_tpu_torch.profile_serving --arch efficientnet_mrlal_b0
    python3 -m mrla_tpu_torch.profile_serving --preset faster_rcnn_r50mrlal_fpn_1x_coco
    python3 -m mrla_tpu_torch.profile_serving --train [--fused-epilogue]
    torchrun --nproc-per-node 1 -m mrla_tpu_torch.profile_serving --train --ddp
    python3 -m mrla_tpu_torch.profile_serving --train --arch deit_mrlal_tiny_patch16_224

Serves ``--arch`` (default resnet50_mrlal through the BN-folded engine;
resnet50_mrlab through the eq. 6 engine, ``--use-scan`` for its masked
cache form; a ``deit_*`` / ``deit_mrlal_*`` / ``deit_mrlab_*`` arch through
the DeiT engine; a baseline resnet / resnext, EfficientNet, ResMLP or
PatchConvNet arch through the precast engine, from
``testing.zoo_serving_model``) at 224 px in
bf16, from seeded weights and images (``mrla_tpu_torch/testing.py``), on
one CUDA card; traces ``FORWARDS`` forwards of batch ``BATCH`` with
torch.profiler after a warm-up, and prints the device time by kernel group
and for the busiest kernels, the wall time of the window, the device's
busy time (the union of its kernels' spans, so that overlapping spans
count once) and its idle share.  With ``--use-stage4`` the traced resnet forwards take the
stage-kernel route.  For resnet50_mrlal it then reads the device time of
the last stage alone on both routes (a trace of the engine's block loop on
the stage-3 output map); for a ``deit_mrlal_*`` arch, the device time of
each pass of the token-tail kernel alone at the three published widths;
for resnet50_mrlab, at each stage's map, the device time of the pieces of
the eq. 6 cache alone: a value map's write into the cache buffer, the
depthwise 3x3 that makes it, and the weighted sum over t at every t of the
stage (per forward, summed over the stage's blocks).

With ``--preset`` (a two-stage detection preset) it serves
``two_stage_detections`` at 800 x 1344, batch 8, bf16 from a seeded
detector (``testing.detector_serving_model``), traces ``FORWARDS``
forwards the same way, and then each stage of the served path alone, as
``two_stage_detections``' ``stage`` hook records them (backbone, FPN, RPN
head, proposals, RoIAlign, box head, decode and class-wise NMS; the mask
RoIAlign and mask head for a mask preset), ``STAGE_RUNS`` times
on the intermediates of one forward: its device time, its launches and its
wall time per run (the host clock around runs that end in a synchronize),
so that stages the host holds up show as wall time above device time.

With ``--train --preset ...`` it profiles detection training instead: the
trainer's step (``detect.train_cli.train_step``) at 800 x 800, batch 8, 80
classes, fp32 (TF32 off), from the trainer's seeded detector; ``FORWARDS``
traced steps after two, then each stage of one step alone as the loss's
``stage`` hook records them (backbone, FPN, RPN head, RPN targets and
loss, proposals, R-CNN targets, RoIAlign, box head, R-CNN loss, and the
mask stages for a mask preset), the RoIAlign backward kernels alone on that
step's rois, the whole backward (retaining the graph) and the optimizer
step.

With ``--train`` and no preset it profiles classification training: the
step of ``train/steps.py`` on the trainer's recipe for ``--arch``
(resnet50_mrlal: 224 px, batch 128, bf16, SGD, label smoothing 0.1, with
``--fused-epilogue`` its fused tails; a ``deit_mrlal_*`` arch: batch 256,
bf16, AdamW, Mixup / CutMix soft targets, drop path 0.1, EMA), from the
trainer's seeded model and synthetic batches; ``FORWARDS`` traced steps
after two, by kernel group, and then the forward with its loss, the
backward (retaining the graph), the optimizer step and the EMA alone.
``--ddp`` runs those steps through DDP, as the trainer does under a launch
(start it with torchrun: at one rank, DDP's cost at world 1).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("mrla mega-tail kernel", ("tail_x1_kernel",)),
    ("mrla epilogue kernel", ("::fromout",)),  # tail_window_kernel<FromOut>
    ("mrla stage-4 kernel (products, z with the tails)",
     ("stage4_product_kernel",)),
    ("convolution", ("conv", "xmma", "gemm", "cutlass", "cudnn", "implicit",
                     "sm90_", "nhwc", "winograd", "fprop")),
    ("reduction (GAP, head)", ("reduce",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
)


DEIT_GROUPS = (
    # pass 2 is a dependent launch: its span starts while pass 1 still
    # runs, so the two groups' sum exceeds the tail's share of busy time
    ("deit token-tail kernel: pass 1", ("deit_tail_pass1_kernel",)),
    ("deit token-tail kernel: pass 2", ("deit_tail_pass2_kernel",)),
    ("attention (fused softmax(QK)V)", ("flash", "fmha", "attention")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("GELU", ("gelu",)),
    ("matrix products (incl. patch embed)",
     ("gemm", "nvjet", "cutlass", "xmma", "cublas", "conv", "sm90_",
      "implicit", "splitk")),
    ("concatenation (cls token)", ("catarray",)),
    ("copies and casts (LayerNorm's fp32 copy, head merge)", ("copy",)),
    ("other elementwise (residual adds, pos)",
     ("elementwise", "vectorized", "unrolled")),
)


MRLAB_GROUPS = (
    ("fp32 multiply-adds (sums over t, BN affine on attn)", ("addcmul",)),
    ("depthwise 3x3 (value maps)", ("conv2d_c1_k1", "depthwise")),
    ("convolution", GROUPS[3][1]),
    ("softmax over t", ("softmax",)),
    ("reduction (GAP, head)", ("reduce",)),
    ("pooling", ("pool",)),
    ("copies and casts (cache writes, accumulator casts)", ("copy",)),
    ("elementwise (bias, ReLU, residual, BN affine)",
     ("elementwise", "vectorized", "unrolled")),
)
DEIT_MRLAB_GROUPS = (
    ("eq. 6 sum over t (fp32 multiply-adds)", ("addcmul",)),
    ("depthwise 3x3 (value maps)", ("conv2d_c1_k1", "depthwise")),
) + DEIT_GROUPS
# resnet50_mrlab at 224 px: each stage's map (H, W, C) and blocks
MRLAB_STAGES = ((56, 56, 256, 3), (28, 28, 512, 4), (14, 14, 1024, 6),
                (7, 7, 2048, 3))


ZOO_GROUPS = (  # the precast engine's archs (BN not folded)
    ("depthwise / grouped convolution",
     ("conv2d_c1_k1", "depthwise", "grouped", "group_conv")),
    ("convolution", GROUPS[3][1]),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_infer")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("matrix products (token mixing, MLP, heads)",
     ("nvjet", "cublas", "splitk", "gemv")),
    ("attention (class attention's softmax)", ("softmax",)),
    ("GELU", ("gelu",)),
    ("SiLU / sigmoid (activations, gates)", ("silu", "sigmoid")),
    ("reduction (GAP, gates' pools, head)", ("reduce",)),
    ("pooling", ("pool",)),
    ("copies and casts", ("copy", "catarray")),
    ("elementwise (residual adds, gates' products, layer scales)",
     ("elementwise", "vectorized", "unrolled")),
)


DETECT_GROUPS = (
    ("roi_align backward kernel", ("roi_align_bwd",)),
    ("roi_align kernel", ("roi_align_fwd_kernel",)),
    ("mrla mega-tail kernel", ("tail_x1_kernel",)),
    ("mrla epilogue kernel", ("::fromout",)),  # tail_window_kernel<FromOut>
    ("sort (top-k)", ("sort", "radix")),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn",
                     "nhwc")),
    ("matrix products (box head, NMS products)",
     ("gemm", "nvjet", "cublas", "gemv", "xmma", "sm90_")),
    ("reduction", ("reduce",)),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
)
DET_HW, DET_BATCH = (800, 1344), 8
ZOO_PREFIXES = ("resnet", "resnext", "efficientnet", "resmlp",
                "patchconvnet")


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


FORWARDS, BATCH = 3, 128
STAGE_RUNS = 20


def device_ms(prof) -> dict:
    """Kernel name -> [device ms, launches] of a finished profile.  A user
    annotation on the device timeline (``Optimizer.step#AdamW.step``
    spans the optimizer's kernels) is a range, not a kernel: left out."""
    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        per_kernel[evt.key][0] += evt.self_device_time_total / 1e3
        per_kernel[evt.key][1] += evt.count
    return per_kernel


def span_union(spans) -> float:
    """The length of the union of (start, end) spans: overlaps count once."""
    total, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def device_busy_ms(prof) -> float:
    """The device's busy ms in a finished profile: the union of the spans
    of its kernels, copies and memsets, so that spans which overlap (a
    dependent launch's start under its primary's end, streams side by
    side) count once.  User annotations are left out, as in device_ms."""
    return span_union(
        (evt.time_range.start, evt.time_range.end) for evt in prof.events()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(evt, "is_user_annotation", False)) / 1e3


def spans_ms(per_kernel) -> float:
    """The device ms of device_ms's kernels summed: above the busy time by
    as much as their spans overlap."""
    return sum(t for t, _ in per_kernel.values())


def stage4_alone(params, x, use_stage4: bool) -> tuple[float, float]:
    """(device ms, kernel launches) per run of the last stage on one route:
    the engine's block loop over the stage's three blocks, from the stage-3
    output map of ``x``.  The device time is the sum over the kernels of a
    trace, so the host's launch gaps (the stage alone does not keep the
    card busy) do not count."""
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.serving.resnet_mrlal import _blocks_impl, _trunk_impl

    c4 = _trunk_impl(params, x, (3, 4, 6, 3), 32)[2]
    stage = {"blocks": params["blocks"][-3:], "stage4": params["stage4"]}
    run = lambda: _blocks_impl(stage, c4, (0, 3), 32, use_stage4)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STAGE_RUNS):
            run()
        torch.cuda.synchronize()
    per_kernel = device_ms(prof)
    return (sum(t for t, _ in per_kernel.values()) / STAGE_RUNS,
            sum(n for _, n in per_kernel.values()) / STAGE_RUNS)


def tail_alone(c: int) -> dict:
    """Device microseconds per launch of each pass of the DeiT token tail
    alone at [BATCH, 197, c], from a trace of ``STAGE_RUNS`` launches."""
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.kernels import deit_token_tail
    from mrla_tpu_torch.testing import deit_tail_case

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, ot, packed = deit_tail_case(gen, BATCH, 197, c)
    for _ in range(3):
        deit_token_tail(x, ot, packed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STAGE_RUNS):
            deit_token_tail(x, ot, packed)
        torch.cuda.synchronize()
    return {name.split("deit_tail_")[1].split("_kernel")[0]:
            round(t * 1e3 / STAGE_RUNS, 2)
            for name, (t, _) in device_ms(prof).items()
            if "deit_tail_" in name}


def mrlab_cache_alone() -> None:
    """Device ms per forward of the eq. 6 cache's pieces alone at each
    stage's map of resnet50_mrlab (224 px, BATCH, bf16): the value maps'
    writes into the buffer, their depthwise 3x3, and the weighted sums over
    t = 1 .. blocks."""
    from mrla_tpu_torch.ops.common import depthwise_conv3x3
    from mrla_tpu_torch.ops.mrla import _weighted_sum, cache_buffers

    gen = torch.Generator(device="cuda").manual_seed(0)
    total = defaultdict(float)
    print(f"eq. 6 cache pieces alone, bs{BATCH} bf16 (device ms per "
          f"forward, {STAGE_RUNS} traced runs each):")
    for h, w, c, n in MRLAB_STAGES:
        _, v_buf = cache_buffers(BATCH, n, h, w, c, torch.bfloat16, "cuda")
        v_buf.normal_(generator=gen)
        x = torch.randn(BATCH, h, w, c, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        wv = torch.randn(c, 1, 3, 3, generator=gen, device="cuda")
        attn = torch.softmax(torch.randn(BATCH, c // 16, n, generator=gen,
                                         device="cuda"), -1)
        pieces = {
            "cache writes": (n, lambda: v_buf[:, n - 1].copy_(x)),
            "depthwise 3x3": (n, lambda: depthwise_conv3x3(x, wv)),
        }
        for t in range(1, n + 1):
            pieces[f"sum over t={t}"] = (
                1, lambda t=t: _weighted_sum(attn, v_buf, t))
        row = {}
        for name, (times, fn) in pieces.items():
            dev_ms = stage_times(fn)[0] * times
            key = "sums over t" if name.startswith("sum") else name
            row[key] = row.get(key, 0.0) + dev_ms
            total[key] += dev_ms
        print(f"  [{BATCH},{h},{w},{c}] x {n} blocks: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()))
    print("  all stages: " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in total.items()))


def stage_times(fn) -> tuple[float, float, float]:
    """(device ms, launches, wall ms) per run of ``fn`` alone."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STAGE_RUNS):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / STAGE_RUNS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STAGE_RUNS):
            fn()
        torch.cuda.synchronize()
    per_kernel = device_ms(prof)
    return (sum(t for t, _ in per_kernel.values()) / STAGE_RUNS,
            sum(n for _, n in per_kernel.values()) / STAGE_RUNS, wall)


def print_groups(per_kernel, busy: float, groups_of, runs: int) -> None:
    groups = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in per_kernel.items():
        g = groups[group_of(name, groups_of)]
        g[0] += t
        g[1] += n
    print("device time by group (ms per run, share of the busy time, "
          "launches per run):")
    for g, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:52s} {t / runs:9.4f} {t / busy:7.3f} {n / runs:7.1f}")


def train_profile(preset: str) -> int:
    """Device time of detection training steps, by kernel group and by
    stage (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.detect.roi_align import roi_geometry
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss
    from mrla_tpu_torch.kernels import roi_align_grad_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    targs = train_cli.parse_args(
        ["--preset", preset, "--img-size", "800", "--batch-size", "8",
         "--num-classes", "80", "--steps-per-epoch", str(FORWARDS + 2)])
    dev = torch.device("cuda")
    model = train_cli.build_model(targs, dev)
    schedule, _ = train_cli.make_schedule(
        targs, train_cli.PRESETS[preset], targs.steps_per_epoch)
    opt = train_cli.make_optimizer(targs, model, schedule)
    rand = torch.Generator(dev).manual_seed(1)
    step_loss = train_cli.StepLoss(model, preset, targs.num_classes,
                                   targs.rcnn_samples)
    batches = [train_cli.to_device(b, dev)
               for b in train_cli.data_iter(targs, True, 0)]
    for b in batches[:2]:
        train_cli.train_step(step_loss, opt, b, rand)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            train_cli.train_step(step_loss, opt, b, rand)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_ms(prof)
    busy = device_busy_ms(prof)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"window: {preset} training, {FORWARDS} steps, bs8, 800x800, "
          f"fp32, wall {wall_ms:.3f} ms ({wall_ms / FORWARDS:.3f} ms/step), "
          f"device busy {busy:.3f} ms ({spans_ms(per_kernel):.3f} summed "
          f"span by span), idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    if busy == 0:
        print("the profiler recorded no device time")
        return 1
    print_groups(per_kernel, busy, DETECT_GROUPS, FORWARDS)

    stages = []  # (name, fn) of each stage of one step

    def record(name, fn, *a, **kw):
        stages.append((name, lambda: fn(*a, **kw)))
        if "RoIAlign" in name:  # and its backward kernel alone, on its rois
            out = a[3] if len(a) > 3 else 7
            hw = [tuple(f.shape[1:3]) for f in a[0][:4]]
            geom, smax = roi_geometry(a[1], a[2], hw, ROI_STRIDES, out,
                                      model.roi_sampling_ratio)
            ct = torch.randn(*a[1].shape[:2], out, out, a[0][0].shape[-1],
                             device=dev)
            stages.append((f"{name} backward kernel",
                           lambda: roi_align_grad_kernel(ct, geom, hw, smax)))
        return fn(*a, **kw)

    b = batches[0]
    total, _, _ = faster_rcnn_train_loss(
        model, b["image"], b["gt_boxes"], b["gt_labels"], b["gt_valid"],
        rand, gt_masks=b.get("gt_masks"), stage=record)
    opt.zero_grad(set_to_none=True)
    stages.append(("backward (all of it)",
                   lambda: total.backward(retain_graph=True)))
    stages.append(("optimizer step", opt.step))
    print(f"each stage alone, {STAGE_RUNS} runs on the intermediates of one "
          f"step (device ms, launches, wall ms per run):")
    for name, fn in stages:
        dev_ms, n, wall = stage_times(fn)
        print(f"  {name:34s} {dev_ms:9.4f} {n:7.1f} {wall:9.3f}")
    return 0


TRAIN_CLS_GROUPS = (
    ("depthwise 3x3 (MRLA V, forward and backward)",
     ("conv2d_c1_k1", "depthwise")),
    ("batch norm (forward and backward)", ("batch_norm", "bn_fw", "bn_bw",
                                           "welford")),
    ("convolution (forward and backward)", ("conv", "xmma", "cudnn",
                                            "implicit", "winograd", "fprop",
                                            "dgrad", "wgrad", "nhwc")),
    ("attention (fused softmax(QK)V, forward and backward)",
     ("flash", "fmha", "attention")),
    ("matrix products", ("gemm", "nvjet", "cutlass", "cublas", "sm90_",
                         "splitk")),
    ("optimizer and EMA (foreach)", ("multi_tensor", "foreach")),
    ("LayerNorm (forward and backward)", ("layer_norm", "layernorm",
                                          "gammabeta")),
    ("GELU", ("gelu",)),
    ("softmax, loss", ("softmax", "nll")),
    ("reduction (GAP, gate, BN stats, norms)", ("reduce",)),
    ("pooling", ("pool",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def classify_profile(arch: str, fused: bool, ddp: bool = False) -> int:
    """Device time of classification training steps on the trainer's
    recipe for ``arch`` (see the module's docstring)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.data import mixup_cutmix, synthetic_batches
    from mrla_tpu_torch.nn import set_generator
    from mrla_tpu_torch.train import (
        cli,
        create_train_state,
        label_smoothing_ce,
        soft_target_ce,
        train_step,
        update_ema,
    )

    deit = arch.startswith("deit")
    argv = ["-a", arch, "--bf16", "--device", "cuda", "--synthetic-steps",
            str(FORWARDS + 2)]
    if deit:
        argv += ["-b", "256", "--opt", "adamw", "--lr", "5e-4",
                 "--lr-scale-512", "--wd", "0.05", "--scheduler", "cosine",
                 "--warmup-epochs", "5", "--ema-decay", "0.99996",
                 "--drop-path", "0.1"]
    else:
        argv += ["-b", "128", "--label-smooth", "0.1"]
        argv += ["--fused-epilogue"] if fused else []
    args = cli.build_parser().parse_args(argv)
    dev = torch.device("cuda")
    model = cli.build_model(args, dev)
    opt, schedule = cli.build_optimizer(args, model, args.synthetic_steps)
    state = create_train_state(model, opt, schedule, args.ema_decay)
    if ddp:
        from mrla_tpu_torch.parallel import data_parallel, init_distributed

        if init_distributed(device=dev)["process_count"] != 1:
            raise SystemExit("--ddp profiles one rank: torchrun "
                             "--nproc-per-node 1")
        state.ddp = data_parallel(model, dev)
    set_generator(model, torch.Generator(dev).manual_seed(1))
    batches = []
    for i, b in enumerate(synthetic_batches(args.batch_size, 224, 1000,
                                            args.synthetic_steps)):
        x = torch.from_numpy(b["image"]).to(dev)
        y = torch.from_numpy(b["label"]).to(dev)
        if deit:
            x, y = mixup_cutmix(np.random.default_rng(i), x, y, 1000,
                                label_smoothing=0.1)
        batches.append({"image": x, "label": y})
    loss_fn = (soft_target_ce if deit else
               lambda lo, la: label_smoothing_ce(lo, la, 0.1))

    def step(b):
        return train_step(state, b, loss_fn, bf16=True)["loss"].item()

    for b in batches[:2]:
        step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_ms(prof)
    busy = device_busy_ms(prof)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"window: {arch} training{' --fused-epilogue' if fused else ''}"
          f"{' under DDP at world 1' if state.ddp is not None else ''}, "
          f"{FORWARDS} steps, bs{args.batch_size}, 224 px, bf16, wall "
          f"{wall_ms:.3f} ms ({wall_ms / FORWARDS:.3f} ms/step), device busy "
          f"{busy:.3f} ms ({spans_ms(per_kernel):.3f} summed span by span), "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    if busy == 0:
        print("the profiler recorded no device time")
        return 1
    print_groups(per_kernel, busy, TRAIN_CLS_GROUPS, FORWARDS)
    print("busiest kernels (ms per step, launches per step):")
    for name, (t, n) in sorted(per_kernel.items(),
                               key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / FORWARDS:9.4f} {n / FORWARDS:7.1f}  {name[:100]}")

    b = batches[0]
    model.train()

    def forward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return loss_fn(model(b["image"]), b["label"])

    loss = forward()
    opt.zero_grad(set_to_none=True)
    loss.backward(retain_graph=True)  # gradients for the optimizer step
    pieces = [("forward and loss", forward),
              ("backward (all of it)",
               lambda: loss.backward(retain_graph=True)),
              ("optimizer step", opt.step)]
    if state.ema is not None:
        pieces.append(("EMA update", lambda: update_ema(state)))
    print(f"each piece alone, {STAGE_RUNS} runs (device ms, launches, wall "
          f"ms per run):")
    for name, fn in pieces:
        dev_ms, n, wall = stage_times(fn)
        print(f"  {name:34s} {dev_ms:9.4f} {n:7.1f} {wall:9.3f}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="resnet50_mrlal",
                        help="resnet50_mrlal, resnet50_mrlab, a deit_* / "
                             "deit_mrlal_* / deit_mrlab_* arch, or a "
                             "baseline resnet / resnext, efficientnet, "
                             "resmlp or patchconvnet arch")
    parser.add_argument("--use-stage4", action="store_true",
                        help="trace resnet50_mrlal's stage-kernel route")
    parser.add_argument("--use-scan", action="store_true",
                        help="trace resnet50_mrlab's masked cache form")
    parser.add_argument("--preset", default=None,
                        help="a two-stage detection preset: trace "
                             "two_stage_detections at 800 x 1344, bs8")
    parser.add_argument("--train", action="store_true",
                        help="trace training steps: with --preset, "
                             "detection at 800 x 800, bs8; else "
                             "classification on --arch's recipe")
    parser.add_argument("--fused-epilogue", action="store_true",
                        help="with --train: resnet50_mrlal's fused tails")
    parser.add_argument("--ddp", action="store_true",
                        help="with --train and no preset: the steps through "
                             "DDP (under torchrun, one rank)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    if args.train:
        if not args.preset:
            try:
                return classify_profile(args.arch, args.fused_epilogue,
                                        args.ddp)
            finally:
                if torch.distributed.is_initialized():
                    torch.distributed.destroy_process_group()
        return train_profile(args.preset)
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.serving import (
        attach_stage4,
        deit_forward,
        prepare_deit_inference_params,
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.testing import (
        deit_serving_model,
        images,
        serving_model,
    )

    deit = args.arch.startswith("deit")
    batch = BATCH
    if args.preset:
        from mrla_tpu_torch.serving import (
            prepare_detect_params,
            two_stage_detections,
        )
        from mrla_tpu_torch.testing import detector_serving_model

        params = prepare_detect_params(
            detector_serving_model(0, args.preset), device="cuda")
        forward = lambda xb: two_stage_detections(params, xb, args.preset)
        route, batch = f", {DET_HW[0]}x{DET_HW[1]}", DET_BATCH
    elif deit:
        params = prepare_deit_inference_params(
            deit_serving_model(args.arch, 0), device="cuda")
        forward = lambda xb: deit_forward(params, xb)
        route = ""
    elif args.arch == "resnet50_mrlab":
        from mrla_tpu_torch.serving import (
            prepare_mrlab_inference_params,
            resnet_mrlab_forward,
        )
        from mrla_tpu_torch.testing import mrlab_serving_model

        params = prepare_mrlab_inference_params(mrlab_serving_model(0),
                                                device="cuda")
        forward = lambda xb: resnet_mrlab_forward(params, xb,
                                                  use_scan=args.use_scan)
        route = f", use_scan={args.use_scan}"
    elif (args.arch.startswith(ZOO_PREFIXES) and "_mrlab" not in args.arch
          and not args.arch.endswith(("_mrlal", "_la_eq4"))):
        from mrla_tpu_torch.serving import (
            precast_forward,
            prepare_precast_inference_params,
        )
        from mrla_tpu_torch.testing import zoo_serving_model

        params = prepare_precast_inference_params(
            zoo_serving_model(args.arch, 0), device="cuda")
        forward = lambda xb: precast_forward(params, xb)
        route = ", precast"
    elif args.arch == "resnet50_mrlal":
        params = attach_stage4(prepare_inference_params(
            serving_model(0), dtype=torch.bfloat16, device="cuda"))
        forward = lambda xb: resnet_mrlal_forward(
            params, xb, use_stage4=args.use_stage4)
        route = f", use_stage4={args.use_stage4}"
    else:
        parser.error(f"no serving profile for --arch {args.arch}")
    mrlab = "mrlab" in args.arch
    zoo = route == ", precast"
    groups_of_arch = (DETECT_GROUPS if args.preset else ZOO_GROUPS if zoo
                      else (DEIT_MRLAB_GROUPS if mrlab else DEIT_GROUPS)
                      if deit else MRLAB_GROUPS if mrlab else GROUPS)
    gen = torch.Generator().manual_seed(1)
    batches = [images(gen, batch, DET_HW if args.preset else 224).cuda()
               for _ in range(FORWARDS)]
    for xb in batches:  # warm-up: build, autotune, allocator
        forward(xb)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for xb in batches:
            forward(xb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = device_ms(prof)
    busy = device_busy_ms(prof)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"window: {args.preset or args.arch}, {FORWARDS} forwards, "
          f"bs{batch}{route}, "
          f"wall {wall_ms:.3f} ms ({wall_ms / FORWARDS:.3f} ms/forward), "
          f"device busy {busy:.3f} ms ({spans_ms(per_kernel):.3f} summed "
          f"span by span), idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    if busy == 0:
        print("the profiler recorded no device time")
        return 1
    print_groups(per_kernel, busy, groups_of_arch, FORWARDS)
    print("busiest kernels (ms per forward, launches per forward):")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, n) in top:
        print(f"  {t / FORWARDS:9.4f} {n / FORWARDS:6.1f}  "
              f"{name[:110]}")
    if args.preset:
        stages = []  # (name, fn) of each stage of one served forward

        def record(name, fn, *a, **kw):
            stages.append((name, lambda: fn(*a, **kw)))
            return fn(*a, **kw)

        print(f"each stage alone, {STAGE_RUNS} runs on the intermediates of "
              f"one forward (device ms, launches, wall ms per run):")
        with torch.inference_mode():
            two_stage_detections(params, batches[0], args.preset,
                                 stage=record)
            for name, fn in stages:
                dev_ms, n, wall = stage_times(fn)
                print(f"  {name:34s} {dev_ms:9.4f} {n:7.1f} {wall:9.3f}")
        return 0
    if mrlab and not deit:
        mrlab_cache_alone()
        return 0
    if zoo:
        return 0
    if deit:
        if params["variant"] == "light":
            print(f"token tail alone, bs{BATCH} (device us per launch of "
                  f"each pass, {STAGE_RUNS} traced launches): "
                  + "; ".join(f"C={c} {tail_alone(c)}"
                              for c in (384, 192, 768)))
        return 0
    alone = {False: [], True: []}
    with torch.inference_mode():
        for route in (False, True, True, False):  # in turns
            alone[route].append(stage4_alone(params, batches[0], route))
    fmt = lambda rs: " / ".join(f"{t:.4f} ms in {n:.0f} launches"
                                for t, n in rs)
    print(f"stage 4 alone, bs{BATCH} (device time of {STAGE_RUNS} traced "
          f"runs each, in turns): per-block kernels {fmt(alone[False])}; "
          f"stage kernel {fmt(alone[True])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
