#!/usr/bin/env python3
"""Where the device time of one of the port's serving forwards goes.

    python3 -m mrla_tpu_torch.profile_serving [--use-stage4]
    python3 -m mrla_tpu_torch.profile_serving --arch deit_mrlal_small_patch16_224
    python3 -m mrla_tpu_torch.profile_serving --preset faster_rcnn_r50mrlal_fpn_1x_coco

Serves ``--arch`` (default resnet50_mrlal through the BN-folded engine; a
``deit_*`` / ``deit_mrlal_*`` arch through the DeiT engine) at 224 px in
bf16, from seeded weights and images (``mrla_tpu_torch/testing.py``), on
one CUDA card; traces ``FORWARDS`` forwards of batch ``BATCH`` with
torch.profiler after a warm-up, and prints the device time by kernel group
and for the busiest kernels, the wall time of the window and the device's
idle share.  With ``--use-stage4`` the traced resnet forwards take the
stage-kernel route.  For resnet50_mrlal it then reads the device time of
the last stage alone on both routes (a trace of the engine's block loop on
the stage-3 output map); for a ``deit_mrlal_*`` arch, the device time of
each pass of the token-tail kernel alone at the three published widths.

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
step.  Needs a CUDA card.
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
    ("mrla epilogue kernel", ("mrla_epilogue_kernel",)),
    ("mrla stage-4 kernel: products", ("stage4_gemm_kernel",)),
    ("mrla stage-4 kernel: tails", ("stage4_tail_kernel",)),
    ("convolution", ("conv", "xmma", "gemm", "cutlass", "cudnn", "implicit",
                     "sm90_", "nhwc", "winograd", "fprop")),
    ("reduction (GAP, head)", ("reduce",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
)


DEIT_GROUPS = (
    ("deit token-tail kernel: stats", ("deit_tail_stats_kernel",)),
    ("deit token-tail kernel: gate", ("deit_tail_gate_kernel",)),
    ("deit token-tail kernel: main", ("deit_tail_main_kernel",)),
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


DETECT_GROUPS = (
    ("roi_align backward kernel", ("roi_align_bwd",)),
    ("roi_align kernel", ("roi_align_kernel",)),
    ("mrla mega-tail kernel", ("tail_x1_kernel",)),
    ("mrla epilogue kernel", ("mrla_epilogue_kernel",)),
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


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


FORWARDS, BATCH = 3, 128
STAGE_RUNS = 20


def device_ms(prof) -> dict:
    """Kernel name -> [device ms, launches] of a finished profile."""
    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        per_kernel[evt.key][0] += evt.self_device_time_total / 1e3
        per_kernel[evt.key][1] += evt.count
    return per_kernel


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
    print("device time by group (ms per run, share, launches per run):")
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
    batches = [train_cli.to_device(b, dev)
               for b in train_cli.data_iter(targs, True, 0)]
    for b in batches[:2]:
        train_cli.train_step(model, opt, b, rand, targs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            train_cli.train_step(model, opt, b, rand, targs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_ms(prof)
    busy = sum(t for t, _ in per_kernel.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"window: {preset} training, {FORWARDS} steps, bs8, 800x800, "
          f"fp32, wall {wall_ms:.3f} ms ({wall_ms / FORWARDS:.3f} ms/step), "
          f"device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="resnet50_mrlal",
                        help="resnet50_mrlal or a deit_* / deit_mrlal_* arch")
    parser.add_argument("--use-stage4", action="store_true",
                        help="trace resnet50_mrlal's stage-kernel route")
    parser.add_argument("--preset", default=None,
                        help="a two-stage detection preset: trace "
                             "two_stage_detections at 800 x 1344, bs8")
    parser.add_argument("--train", action="store_true",
                        help="with --preset: trace a training step at "
                             "800 x 800, bs8 instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    if args.train:
        if not args.preset:
            parser.error("--train needs --preset")
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
    elif args.arch == "resnet50_mrlal":
        params = attach_stage4(prepare_inference_params(
            serving_model(0), dtype=torch.bfloat16, device="cuda"))
        forward = lambda xb: resnet_mrlal_forward(
            params, xb, use_stage4=args.use_stage4)
        route = f", use_stage4={args.use_stage4}"
    else:
        parser.error(f"no serving profile for --arch {args.arch}")
    groups_of_arch = (DETECT_GROUPS if args.preset
                      else DEIT_GROUPS if deit else GROUPS)
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
    busy = sum(t for t, _ in per_kernel.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"window: {args.preset or args.arch}, {FORWARDS} forwards, "
          f"bs{batch}{route}, "
          f"wall {wall_ms:.3f} ms ({wall_ms / FORWARDS:.3f} ms/forward), "
          f"device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
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
    if deit:
        if params["dim_mrla"] is not None:
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
