#!/usr/bin/env python3
"""Drive the PyTorch port (mrla_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

  1. device: the card's name, the device count and nvidia-smi's name and
     power limit;
  2. build: nvcc compiles the kernels from mrla_tpu_torch/csrc (one process
     per source, in parallel); ptxas' registers / shared memory / spills of
     each kernel are printed;
  3. kernels: each kernel's wrapper against its plain PyTorch version on the
     card, in bf16, at every shape the main paths (224 px, batch 128) give
     it, and the epilogue and mega-tail also at every shape the detection
     path (800 x 1344, batch 8) gives them, with its time (CUDA events),
     its bound and the plain version's time; the DeiT token tail also at
     the other two published widths and at a batch of 3, and its cls rows
     with ot doubled; the block tail from z (the HWBC block tail's kernel
     too), the row tail and the copy at every shape the tail routes give
     them and at the JAX package's test shapes (the row tail with and
     without x1; the copy held bitwise, a new tensor, and timed in turns
     with x.clone()); at each mega-tail and row-tail shape also, as
     diagnostics, the row tail's y alone, the product alone as one PyTorch
     expression, and the launch's tile, blocks an SM and waves; at each
     block-tail shape the segment a thread walks, blocks an SM and waves;
  4. serving: resnet50_mrlal at 224 px, batch 128, bf16 through the
     BN-folded engine for 4 requests, from seeded random weights with a
     non-zero bn3 scale and BN statistics set from seeded images
     (mrla_tpu_torch/testing.py), on both routes: the per-block kernels
     (use_stage4=False) and the stage kernel (attach_stage4,
     use_stage4=True).  On each route the counts are set to 0 just before
     the requests and read just after; the launches counted by shape must
     be exactly the tables below (7 mega-tail + 9 epilogue per forward; 7
     mega-tail + 6 epilogue + 1 stage kernel), the logits finite, and,
     against the port's own fp32 forward on the CPU for 32 images, the
     top-1 class the same for the 8 whose fp32 decision is clearest and
     the logit error (see logit_error) within LOGIT_ERROR_TOL; the engine
     with one wiring fault (in any one block; in the stage kernel's
     packing or its strided input) must fail that check;
  5. throughput: img/s over 20 forwards of each route, in turns, and the
     peak device memory; then the three tail routes on the same params
     (serving/tail_routes.py: rowtail, every block's tail in the row-tail
     kernel, the next conv1 inside it; block_tail, the HWBC block tail on
     maps 28 or more wide and the block tail on the rest; copy, block_tail
     with the copy kernel after each stage-1 block): 4 requests each with
     the launches by shape exactly the tables below (no mega-tail nor
     epilogue launch), the same logit check with one injected wiring
     fault per route that must fail it (TAIL_FAULTS), copy's logits
     bitwise block_tail's, and img/s in turns with the default route;
  6. serving and throughput of deit_mrlal_small_patch16_224 (full depth,
     224 px, batch 128, bf16) through prepare_deit_inference_params /
     deit_forward, from seeded weights spread as a trained model's
     (mrla_tpu_torch/testing.py): exactly 12 token-tail launches per
     forward at (128, 197, 384), finite logits, the same top-1 and
     logit-error check (DEIT_LOGIT_ERROR_TOL), and four injected wiring
     faults that must each fail it;
  7. two-stage detection: faster_rcnn_r50mrlal_fpn_1x_coco (and the mask
     preset) at 800 x 1344, batch 8, bf16, full depth, 80 classes, through
     prepare_detect_params / two_stage_detections, from a seeded detector
     (mrla_tpu_torch/testing.py: detector_serving_model).  First the
     RoIAlign kernel against its plain version on the rois the path makes
     (8 x 1000 proposals at 7 x 7; 8 x 100 detections at 14 x 14), in bf16
     and in fp32, with its time, bound and plain time.  Then 2 requests on
     each preset with the launches counted by shape (RoIAlign 1 per
     forward, 2 with masks; mega-tail 12 and epilogue 4, the table below),
     finite outputs and a detection in every image; against the port's fp32
     forward on the CPU (the nn.Module MaskRCNN, 2 images): the pyramid
     P2..P6, and the RoI features and the box head's (cls, reg) on the
     CPU's proposals, each within its tolerance, while each of four
     injected wiring faults (the box head flattening [7, 7, C] where
     [C, 7, 7] is wanted, rois with x and y swapped, the level mapping one
     level up, one FPN top-down add left out) fails it; img/s over 20
     forwards of each preset and the peak memory;
  8. two-stage detection training (fp32, TF32 off): the RoIAlign backward
     kernel against its plain version on the sampled rois of one 800 x 800,
     batch 8 step of the mask preset (512 rois at 7 x 7, 128 at 14 x 14)
     with a seeded cotangent, run twice (the two runs bitwise equal), with
     its time (the rois' boxes inside), bound and plain time, and the
     forward kernel at the training shapes; the wrapper's autograd on the
     card against CPU copies, and a backward that
     ignores valid, which must fail that check; one full-depth step at 800
     x 800, batch 2, on the card against the same step on the CPU (loss
     terms; the R-CNN loss's gradient to P2..P5 on the CPU's sampled rois),
     with three injected backward faults (x and y swapped, the gradient one
     level up, the cotangent dropped) that must each fail it; the trainer
     (detect/train_cli.py main) at 800 x 800, batch 8, 80 classes for the
     faster preset, the mask preset and the faster preset with --bf16: 2 +
     8 steps with the counts set to 0 just before and read just after,
     ms / step, img/s, peak memory, finite losses and the RoIAlign launches
     per step by shape (forward, backward, gt mask crop; the tables below);
     a small detector learning the synthetic task (the loss must fall);
  9. one JSON line listing each ported kernel, its per-forward (per-step
     for the backward) numbers weighted by the launches counted by shape on
     its main path;
 10. the nvidia-smi line, then the result line
     {"ok": true, "device": {"platform": "gpu", ...}}.

It needs one CUDA card and exits non-zero without printing a result when
there is none, or when the mrla_tpu_torch package is not beside it.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

BATCH, PX, REQUESTS, TIMED_FORWARDS = 128, 224, 4, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
TAIL_FP32_OPS = 24  # per element: 9 taps (FMA = 2), gate, λ·id, BN, residual
# logit_error of the served bf16 logits against the fp32 CPU forward: a
# sound run on an H100 reads 0.0179, and one wiring fault in one block
# 0.115 at the least (both printed by this script; readings in PERF.md)
LOGIT_ERROR_TOL = 0.05

# The shapes the resnet50_mrlal main path (224 px, batch 128) gives each
# kernel, keyed as the wrapper's counter keys its launches, with a label
# and the launches per forward: (B, H, W, C) for the epilogue and
# (B, H, W, C, C1) for the mega-tail.  serve() asserts that the main path
# launched exactly these.
EPILOGUE_SHAPES = {
    (BATCH, 14, 14, 1024): ("stage3", 6),
    (BATCH, 7, 7, 2048): ("stage4", 3),
}
# With use_stage4=True the stage kernel, keyed (B, CIN, C1, C), takes the
# place of stage 4's three epilogues.
STAGE4_SHAPES = {
    (BATCH, 1024, 512, 2048): ("layer4_0 conv3 .. layer4_2", 1),
}
# The DeiT main path: deit_mrlal_small_patch16_224, keyed (B, N, C).
DEIT_ARCH = "deit_mrlal_small_patch16_224"
DEIT_TAIL_SHAPES = {
    (BATCH, 197, 384): ("blocks 0..11", 12),
}
# further shapes the token tail is checked at: the other published widths
# and a batch whose B * N is no multiple of 8
DEIT_TAIL_EXTRA_SHAPES = [(BATCH, 197, 192), (BATCH, 197, 768), (3, 197, 384)]
# per element: two LayerNorms (8 each), GAP, 9 taps (FMA = 2), erf GELU
# (about 23), gate, λ·normo, residual
DEIT_TAIL_FP32_OPS = 60
# logit_error of the served DeiT logits: a sound run on an H100 and the
# least of the four injected faults are printed by this script (readings in
# PERF.md); the bf16 engine on the CPU reads 0.018 and the least fault 0.34
DEIT_LOGIT_ERROR_TOL = 0.06
MEGATAIL_SHAPES = {
    (BATCH, 56, 56, 256, 64): ("layer1_0..1", 2),
    (BATCH, 56, 56, 256, 128): ("layer1_2", 1),
    (BATCH, 28, 28, 512, 128): ("layer2_0..2", 3),
    (BATCH, 28, 28, 512, 256): ("layer2_3", 1),
}

# The tail routes of resnet50_mrlal serving (serving/tail_routes.py) at 224
# px, batch 128, keyed as the wrappers' counters key their launches:
# (B, H, W, C, C1) for the row tail (C1 = 0: y alone), (B, H, W, C) for the
# block tails and the copy.  serve_tail_routes() asserts exactly these.
TAIL_PATHS = {t: f"tail route {t}" for t in ("rowtail", "block_tail",
                                               "copy")}
ROWTAIL_SHAPES = {
    (BATCH, 56, 56, 256, 64): ("layer1_0..1", 2),
    (BATCH, 56, 56, 256, 128): ("layer1_2", 1),
    (BATCH, 28, 28, 512, 128): ("layer2_0..2", 3),
    (BATCH, 28, 28, 512, 256): ("layer2_3", 1),
    (BATCH, 14, 14, 1024, 256): ("layer3_0..4", 5),
    (BATCH, 14, 14, 1024, 512): ("layer3_5", 1),
    (BATCH, 7, 7, 2048, 512): ("layer4_0..1", 2),
    (BATCH, 7, 7, 2048, 0): ("layer4_2", 1),
}
HWBC_SHAPES = {  # maps 28 or more wide: the HWBC block tail
    (BATCH, 56, 56, 256): ("stage1", 3),
    (BATCH, 28, 28, 512): ("stage2", 4),
}
BLOCK_TAIL_SHAPES = {
    (BATCH, 14, 14, 1024): ("stage3", 6),
    (BATCH, 7, 7, 2048): ("stage4", 3),
}
COPY_SHAPES = {(BATCH, 56, 56, 256): ("after layer1_0..2", 3)}
TAIL_TABLES = {
    "rowtail": {"rowtail": ROWTAIL_SHAPES},
    "block_tail": {"block_tail_hwbc": HWBC_SHAPES,
                   "block_tail": BLOCK_TAIL_SHAPES},
    "copy": {"block_tail_hwbc": HWBC_SHAPES, "block_tail": BLOCK_TAIL_SHAPES,
             "copy": COPY_SHAPES},
}
# further shapes the new kernels are checked at: the JAX package's tests'
# (tests/test_kernels_tpu.py, tests/test_rowtail_kernel.py, each row tail
# also without x1) and odd ones
BLOCK_TAIL_EXTRA_SHAPES = [(2, 8, 8, 128), (8, 16, 16, 256), (3, 16, 16, 256),
                           (3, 2, 7, 64)]
ROWTAIL_EXTRA_SHAPES = [
    (b, h, w, c, c1) for b, h, w, c, c1_ in [
        (8, 6, 5, 256, 64), (8, 7, 7, 128, 128), (16, 14, 14, 512, 256),
        (8, 2, 3, 128, 64)] for c1 in (c1_, 0)]
COPY_EXTRA_SHAPES = [(3, 4, 5, 64), (8, 4, 4, 128)]
# one wiring fault in one block of each route, each of which must fail the
# logit check: the row tail given zeros for the identity of its ls·id term
# (at a stage-1, a stage-2 and the last block); the block tail given z and
# the identity swapped (an HWBC and a plain block tail); the copy after
# layer1_1 handing on its copy of layer1_0's output
TAIL_FAULTS = {"rowtail": [("no_id", 0), ("no_id", 5), ("no_id", 15)],
               "block_tail": [("swap", 0), ("swap", 10)],
               "copy": [("stale", 1)]}

# The detection path: two-stage presets at the daemon's defaults (batch 8,
# 800 x 1344, bf16, 1000 proposals, 100 detections, score_thr 0.05).  Its
# trunk sends a block to the mega-tail only where the kernel covers (C, next
# C1) (megatail_covers): not layer3_5 (next C1 512) nor stage 4 (C 2048).
DET_PRESET = "faster_rcnn_r50mrlal_fpn_1x_coco"
MASK_PRESET = "mask_rcnn_r50mrlal_fpn_1x_coco"
DET_PATH, MASK_PATH = "faster_rcnn_r50mrlal", "mask_rcnn_r50mrlal"
DET_BATCH, DET_HW, DET_REQUESTS = 8, (800, 1344), 2
DET_MEGATAIL_SHAPES = {
    (DET_BATCH, 200, 336, 256, 64): ("det layer1_0..1", 2),
    (DET_BATCH, 200, 336, 256, 128): ("det layer1_2", 1),
    (DET_BATCH, 100, 168, 512, 128): ("det layer2_0..2", 3),
    (DET_BATCH, 100, 168, 512, 256): ("det layer2_3", 1),
    (DET_BATCH, 50, 84, 1024, 256): ("det layer3_0..4", 5),
}
DET_EPILOGUE_SHAPES = {
    (DET_BATCH, 50, 84, 1024): ("det layer3_5", 1),
    (DET_BATCH, 25, 42, 2048): ("det layer4_0..2", 3),
}
# RoIAlign, keyed (B, P, out, C): the box head's input on both presets, the
# mask head's on the mask preset
ROI_SHAPES = {(DET_BATCH, 1000, 7, 256): ("box head", 1)}
MASK_ROI_SHAPES = {(DET_BATCH, 100, 14, 256): ("mask head", 1)}
# fp32 RoIAlign: a bin sums at most 4 corners x 7 x 7 slots of weights that
# add up to at most 1, so reassociation moves it by at most that many fp32
# roundings of the largest |feature|
ROI_FP32_TERMS = 4 * 7 * 7
ROI_FP32_OPS = 8  # per sample and channel: 4 corners, multiply and add
# Errors of the served bf16 detection path against the port's fp32 forward
# on the CPU (see det_errors): the pyramid and the RoI features relative to
# their norm, the box head's (cls, reg) relative to their image- and
# roi-dependent part.  Set between the sound reading and the least injected
# fault (both printed by this script; readings in PERF.md).
DET_TOLS = {"pyramid": 0.08, "roi": 0.08, "head": 0.15}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, mm_flops: float, ew_flops: float):
    """The least time (ms) the card could take and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(mm_flops / BF16_TENSOR_FLOPS, ew_flops / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tail_inputs(gen, shape):
    dev = "cuda"
    b, h, w, c = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(
        out=rnd(b, h, w, c).mul_(0.5).relu_().bfloat16(),
        identity=rnd(b, h, w, c).bfloat16(),
        gate=torch.sigmoid(rnd(b, c)),
        wv=rnd(9, c).mul_(0.3),
        lam=rnd(c),
        bn_scale=rnd(c).mul_(0.2).add_(1.0),
        bn_bias=rnd(c).mul_(0.2),
    )


def ulp_tol(ref: torch.Tensor, ulps: int) -> float:
    """``ulps`` bf16 units in the last place at the largest |ref|."""
    return ulps * 2.0 ** -7 * ref.abs().max().item()


def tail_x1_diagnostics(lib, kind: str, a: dict, w1, b1, shape) -> dict:
    """What sets the time of a tail + next-conv1 kernel ("megatail" or
    "rowtail", csrc/tail_x1.cuh) at ``shape`` (B, H, W, C, C1): the row
    tail's y alone (its C1 = 0 kernel) on the same map; the product alone,
    relu(y @ W1^T + b1) in bf16 on the same [P, C] x [C, C1] as one PyTorch
    expression (a diagnostic: the port never calls it, and it is not the
    kernel's function); and the launch's tile, its blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and waves."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.mrla_rowtail import _fold

    b, h, w, c, c1 = shape
    gs, ls = _fold(a["gate"], a["lam"], a["bn_scale"])
    y = torch.empty_like(a["out"])
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a["out"].data_ptr(), a["identity"].data_ptr(), gs.data_ptr(),
            a["wv"].data_ptr(), ls.data_ptr(), a["bn_bias"].data_ptr()]
    y_only_ms = cuda_ms(lambda: lib.mrla_rowtail_bf16(
        *ptrs, None, None, y.data_ptr(), None, b, h, w, c, 0, stream))
    y2d, b1h = a["out"].reshape(-1, c), b1.bfloat16()
    product_ms = cuda_ms(lambda: torch.relu(y2d @ w1.t() + b1h))
    out = (ctypes.c_int * 6)()
    check(getattr(lib, f"mrla_{kind}_describe")(c, c1, ctypes.addressof(out)),
          f"mrla_{kind}_describe (C={c}, C1={c1})")
    per_sm, pixels, cols, stages, depth, smem = out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-b * h * w // pixels)
    return dict(y_only_ms=y_only_ms, product_ms=product_ms,
                blocks_per_sm=per_sm, blocks=blocks,
                waves=blocks / (per_sm * sms),
                tile=dict(pixels=pixels, columns=cols, ring_stages=stages,
                          k_depth=depth, smem_bytes=smem))


def diagnostics_text(d: dict) -> str:
    t = d["tile"]
    return (f"y alone {d['y_only_ms']:.4f} ms, product alone (torch, "
            f"diagnostic) {d['product_ms']:.4f} ms; tile {t['pixels']} px x "
            f"{t['columns']} cols, {t['ring_stages']} x {t['k_depth']}-deep "
            f"ring, {t['smem_bytes']} B; {d['blocks_per_sm']} blocks an SM, "
            f"{d['blocks']} blocks, {d['waves']:.2f} waves")


def check_kernels(lib):
    from mrla_tpu_torch.kernels import (
        fused_epilogue,
        fused_epilogue_reference,
        mrla_block_tail_fused_next,
        mrla_block_tail_fused_next_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"epilogue": {}, "megatail": {}}
    for shape, (stage, _) in {**EPILOGUE_SHAPES,
                              **DET_EPILOGUE_SHAPES}.items():
        b, h, w, c = shape
        a = tail_inputs(gen, shape)
        y = fused_epilogue(**a)
        y_ref = fused_epilogue_reference(**a)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = ulp_tol(y_ref.float(), 1)
        ptrs = [a[k].data_ptr() for k in ("out", "identity", "gate", "wv",
                                          "lam", "bn_scale", "bn_bias")]
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.mrla_epilogue_bf16(
            *ptrs, y.data_ptr(), b, h, w, c, stream))
        plain_ms = cuda_ms(lambda: fused_epilogue_reference(**a), iters=5)
        n = b * h * w * c
        bound_ms, by = bound(3 * n * 2 + b * c * 4 + 12 * c * 4, 0,
                             TAIL_FP32_OPS * n)
        rows["epilogue"][shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}]", max_abs_err=err,
            tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        print(f"epilogue {stage} [{b},{h},{w},{c}] bf16: max|Δy| {err:.3g}"
              f" (tol {tol:.3g}: 1 bf16 ulp at max|y|; both round one fp32"
              f" value summed in another order) | kernel {ms:.4f} ms, bound"
              f" {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"epilogue {stage}: {err} > {tol}")
        del a, y, y_ref

    for shape, (stage, _) in {**MEGATAIL_SHAPES,
                              **DET_MEGATAIL_SHAPES}.items():
        b, h, w, c, c1 = shape
        a = tail_inputs(gen, shape[:4])
        w1 = (torch.randn(c1, c, generator=gen, device="cuda")
              / c ** 0.5).bfloat16()
        b1 = torch.randn(c1, generator=gen, device="cuda") * 0.2
        y, x1 = mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
        y_ref, x1_ref = mrla_block_tail_fused_next_reference(
            **a, w1_next=w1, b1_next=b1)
        err_y = (y.float() - y_ref.float()).abs().max().item()
        err_x1 = (x1.float() - x1_ref.float()).abs().max().item()
        tol_y = ulp_tol(y_ref.float(), 1)
        tol_x1 = ulp_tol(x1_ref.float(), 2)
        ptrs = [a[k].data_ptr() for k in ("out", "identity", "gate", "wv",
                                          "lam", "bn_scale", "bn_bias")]
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.mrla_megatail_bf16(
            *ptrs, w1.data_ptr(), b1.data_ptr(), y.data_ptr(), x1.data_ptr(),
            b, h, w, c, c1, stream))
        plain_ms = cuda_ms(lambda: mrla_block_tail_fused_next_reference(
            **a, w1_next=w1, b1_next=b1), iters=5)
        p = b * h * w
        n = p * c
        nbytes = (3 * n * 2 + p * c1 * 2 + c * c1 * 2 + c1 * 4
                  + b * c * 4 + 12 * c * 4)
        bound_ms, by = bound(nbytes, 2 * p * c * c1, TAIL_FP32_OPS * n)
        diag = tail_x1_diagnostics(lib, "megatail", a, w1, b1, shape)
        rows["megatail"][shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}] C1={c1}",
            max_abs_err=max(err_y, err_x1), tol=min(tol_y, tol_x1), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, **diag)
        print(f"megatail {stage} [{b},{h},{w},{c}] C1={c1} bf16: "
              f"max|Δy| {err_y:.3g} (tol {tol_y:.3g}: 1 bf16 ulp at max|y|), "
              f"max|Δx1| {err_x1:.3g} (tol {tol_x1:.3g}: 2 bf16 ulps at "
              f"max|x1|, its own rounding plus y's one-ulp flips) | kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{plain_ms:.4f} ms | {diagnostics_text(diag)}")
        if not (err_y <= tol_y and err_x1 <= tol_x1):
            raise AssertionError(f"megatail {stage}: y {err_y} > {tol_y} or "
                                 f"x1 {err_x1} > {tol_x1}")
        del a, y, x1, y_ref, x1_ref
    rows["stage4"] = check_stage4(gen)
    rows["deit_tail"] = check_deit_tail(lib, gen)
    # the HWBC block tail launches the block-tail kernel: one set of rows
    rows["block_tail"] = rows["block_tail_hwbc"] = check_block_tail(lib, gen)
    rows["rowtail"] = check_rowtail(lib, gen)
    rows["copy"] = check_copy(lib, gen)
    torch.cuda.synchronize()
    return rows


def block_tail_launch(lib, shape) -> dict:
    """The block-tail kernel's launch at ``shape`` (B, H, W, C): the
    segment a thread walks, threads a block, columns in a thread's cp.async
    ring, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    blocks and waves."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check

    out = (ctypes.c_int * 5)()
    check(lib.mrla_block_tail_describe(*shape, ctypes.addressof(out)),
          f"mrla_block_tail_describe {shape}")
    seg, threads, per_sm, blocks, stages = out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(segment=seg, threads=threads, blocks_per_sm=per_sm,
                blocks=blocks, waves=blocks / (per_sm * sms),
                ring_columns=stages)


def check_block_tail(lib, gen):
    """The block-tail kernel (the route's mrla_block_tail and
    mrla_block_tail_hwbc) against its plain version at every shape of the
    block_tail route and the JAX tests' shapes, with its launch (segment,
    blocks an SM, waves)."""
    from mrla_tpu_torch.kernels import (
        fused_block_tail,
        fused_block_tail_reference,
    )

    rows = {}
    shapes = {**HWBC_SHAPES, **BLOCK_TAIL_SHAPES}
    shapes.update({s: ("JAX test / odd", 0) for s in BLOCK_TAIL_EXTRA_SHAPES})
    for shape, (stage, _) in shapes.items():
        b, h, w, c = shape
        a = tail_inputs(gen, shape)
        a["z"] = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        args = [a[k] for k in ("z", "identity", "gate", "wv", "lam",
                               "bn_scale", "bn_bias")]
        y = fused_block_tail(*args)
        y_ref = fused_block_tail_reference(*args)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = ulp_tol(y_ref.float(), 1)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in args]
        ms = cuda_ms(lambda: lib.mrla_block_tail_bf16(
            *ptrs, y.data_ptr(), b, h, w, c, stream))
        plain_ms = cuda_ms(lambda: fused_block_tail_reference(*args), iters=5)
        n = b * h * w * c
        # relu(z + id) adds 2 operations an element to the epilogue's
        bound_ms, by = bound(3 * n * 2 + b * c * 4 + 12 * c * 4, 0,
                             (TAIL_FP32_OPS + 2) * n)
        launch = block_tail_launch(lib, shape)
        rows[shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}]", max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            **launch)
        print(f"block tail {stage} [{b},{h},{w},{c}] bf16: max|Δy| {err:.3g}"
              f" (tol {tol:.3g}: 1 bf16 ulp at max|y|) | kernel {ms:.4f} ms,"
              f" bound {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms | "
              f"segment {launch['segment']} px, {launch['threads']} threads "
              f"a block, a ring of {launch['ring_columns']} columns, "
              f"{launch['blocks_per_sm']} blocks an SM, {launch['blocks']} "
              f"blocks, {launch['waves']:.2f} waves")
        if not err <= tol:
            raise AssertionError(f"block tail {shape}: {err} > {tol}")
        del a, args, y, y_ref
    return rows


def check_rowtail(lib, gen):
    """The row-tail kernel against its plain version at every shape of the
    rowtail route and the JAX row-tail test's shapes, with and without x1."""
    from mrla_tpu_torch.kernels import mrla_rowtail, mrla_rowtail_reference
    from mrla_tpu_torch.kernels.mrla_rowtail import _fold

    rows = {}
    shapes = dict(ROWTAIL_SHAPES)
    shapes.update({s: ("JAX test", 0) for s in ROWTAIL_EXTRA_SHAPES})
    for shape, (stage, _) in shapes.items():
        b, h, w, c, c1 = shape
        a = tail_inputs(gen, shape[:4])
        args = [a[k] for k in ("out", "identity", "gate", "wv", "lam",
                               "bn_scale", "bn_bias")]
        w1 = (torch.randn(c1, c, generator=gen, device="cuda")
              / c ** 0.5).bfloat16()
        b1 = torch.randn(c1, generator=gen, device="cuda") * 0.2
        extra = [w1, b1] if c1 else []
        got = mrla_rowtail(*args, *extra)
        want = mrla_rowtail_reference(*args, *extra)
        y, y_ref = (got[0], want[0]) if c1 else (got, want)
        err_y = (y.float() - y_ref.float()).abs().max().item()
        tol_y = ulp_tol(y_ref.float(), 1)
        err_x1, tol_x1 = 0.0, math.inf
        if c1:
            err_x1 = (got[1].float() - want[1].float()).abs().max().item()
            tol_x1 = ulp_tol(want[1].float(), 2)
        gs, ls = _fold(a["gate"], a["lam"], a["bn_scale"])
        x1 = got[1] if c1 else None
        ptr = lambda t: t.data_ptr() if t is not None else None
        ptrs = [a["out"].data_ptr(), a["identity"].data_ptr(), gs.data_ptr(),
                a["wv"].data_ptr(), ls.data_ptr(), a["bn_bias"].data_ptr(),
                ptr(w1 if c1 else None), ptr(b1 if c1 else None),
                y.data_ptr(), ptr(x1)]
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.mrla_rowtail_bf16(*ptrs, b, h, w, c, c1,
                                                   stream))
        plain_ms = cuda_ms(lambda: mrla_rowtail_reference(*args, *extra),
                           iters=5)
        p = b * h * w
        n = p * c
        nbytes = (3 * n * 2 + p * c1 * 2 + c * c1 * 2 + c1 * 4 + b * c * 4
                  + 11 * c * 4)
        bound_ms, by = bound(nbytes, 2 * p * c * c1, TAIL_FP32_OPS * n)
        diag = (tail_x1_diagnostics(lib, "rowtail", a, w1, b1, shape)
                if c1 else {})
        rows[shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}] C1={c1}",
            max_abs_err=max(err_y, err_x1), tol=min(tol_y, tol_x1), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, **diag)
        print(f"row tail {stage} [{b},{h},{w},{c}] C1={c1} bf16: max|Δy| "
              f"{err_y:.3g} (tol {tol_y:.3g}: 1 bf16 ulp at max|y|), "
              f"max|Δx1| {err_x1:.3g} (tol {tol_x1:.3g}: 2 bf16 ulps at "
              f"max|x1|) | kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}), plain {plain_ms:.4f} ms"
              + (f" | {diagnostics_text(diag)}" if diag else ""))
        if not (err_y <= tol_y and err_x1 <= tol_x1):
            raise AssertionError(f"row tail {shape}: y {err_y} > {tol_y} or "
                                 f"x1 {err_x1} > {tol_x1}")
        del a, args, got, want, y, y_ref, x1
    return rows


def check_copy(lib, gen):
    """The copy kernel held bitwise to its input at the copy route's shape
    and odd ones, a new tensor each time, through the wrapper and through
    its C entry point over a NaN-filled buffer; the kernel and x.clone()
    timed in turns: clone, kernel, kernel, clone, each reading the mean of
    100 launches after 20 (they differ by tenths of a percent).  ms is the
    kernel's two readings' mean, library_ms the clones'."""
    from mrla_tpu_torch.kernels import hwbc_copy, hwbc_copy_reference
    from mrla_tpu_torch.kernels._build import check

    rows = {}
    shapes = dict(COPY_SHAPES)
    shapes.update({s: ("odd", 0) for s in COPY_EXTRA_SHAPES})
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (stage, _) in shapes.items():
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        y = hwbc_copy(x)
        z = torch.full_like(x, float("nan"))
        launch = lambda: lib.hwbc_copy_bf16(x.data_ptr(), z.data_ptr(), b, h,
                                            w, c, stream)
        check(launch(), "hwbc_copy_bf16")
        torch.cuda.synchronize()
        same = (torch.equal(y, x) and y.data_ptr() != x.data_ptr()
                and torch.equal(z, x))
        ms_of = lambda fn: cuda_ms(fn, iters=100, warmup=20)
        turns = [ms_of(lambda: x.clone()), ms_of(launch), ms_of(launch),
                 ms_of(lambda: x.clone())]
        clone, kernel = turns[::3], turns[1:3]
        ms = sum(kernel) / 2
        library_ms = sum(clone) / 2
        plain_ms = cuda_ms(lambda: hwbc_copy_reference(x), iters=5)
        n = b * h * w * c
        bound_ms, by = bound(4 * n, 0, 0)
        rows[shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}]", max_abs_err=0.0 if same else
            (y.float() - x.float()).abs().max().item(), tol=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=library_ms, clone_ms=clone, kernel_ms=kernel)
        print(f"copy {stage} [{b},{h},{w},{c}] bf16: "
              f"{'bitwise equal, a new tensor' if same else 'DIFFERS'} (the "
              f"wrapper and the entry point) | kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms, x.clone() "
              f"{library_ms:.4f} ms | in turns: "
              + ", ".join(f"{t:.4f}" for t in turns) + " ms")
        if not same:
            raise AssertionError(f"copy {shape}: not a new equal tensor")
        del x, y, z
    return rows


def check_deit_tail(lib, gen):
    """The DeiT token tail against its plain version at the main path's
    shape, the other published widths and a batch of 3, from seeded tokens
    and weights (mrla_tpu_torch/testing.py)."""
    from mrla_tpu_torch.kernels import (
        deit_token_tail,
        deit_token_tail_reference,
    )
    from mrla_tpu_torch.testing import deit_tail_case

    rows = {}
    for shape in list(DEIT_TAIL_SHAPES) + DEIT_TAIL_EXTRA_SHAPES:
        b, n, c = shape
        x, ot, packed = deit_tail_case(gen, b, n, c)
        out = deit_token_tail(x, ot, packed)
        ref = deit_token_tail_reference(x, ot, packed)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ulp_tol(ref.float(), 1)
        # the cls rows take x + LN_x(x) and must not see ot
        cls_same = torch.equal(deit_token_tail(x, ot * 2, packed)[:, 0],
                               out[:, 0])
        ktap = packed.taps.shape[1]
        scratch = torch.empty(
            b * lib.deit_token_tail_scratch_per_image(n, c, 16, ktap),
            device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.deit_token_tail_bf16(
            x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
            packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            b, n, c, 16, ktap, stream))
        plain_ms = cuda_ms(
            lambda: deit_token_tail_reference(x, ot, packed), iters=5)
        elems = b * n * c
        bound_ms, by = bound(3 * elems * 2 + 14 * c * 4 + 2 * ktap * 4, 0,
                             DEIT_TAIL_FP32_OPS * elems)
        rows[shape] = dict(
            shape=f"x, ot [{b},{n},{c}]", max_abs_err=err, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        print(f"deit tail [{b},{n},{c}] bf16: max|Δout| {err:.3g} (tol "
              f"{tol:.3g}: 1 bf16 ulp at max|out| = "
              f"{ref.float().abs().max().item():.3g}; both round one fp32 "
              f"value summed in another order); cls rows with ot doubled "
              f"{'unchanged' if cls_same else 'CHANGED'} | kernel {ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"deit tail {shape}: {err} > {tol}")
        if not cls_same:
            raise AssertionError(f"deit tail {shape}: the cls rows depend "
                                 "on ot")
        del x, ot, out, ref, scratch
    return rows


def check_stage4(gen):
    """The stage kernel against its plain version at the main path's shape,
    from seeded weights scaled by fan-in (mrla_tpu_torch/testing.py)."""
    from mrla_tpu_torch.kernels import (
        stage4_resident,
        stage4_resident_reference,
    )
    from mrla_tpu_torch.testing import stage4_case

    rows = {}
    for shape, (stage, _) in STAGE4_SHAPES.items():
        b, cin, c1, c = shape
        # xs is a strided view of the stage's input, read in place
        ob, xs, packed = stage4_case(gen, b, cin, c1, c)
        y = stage4_resident(ob, xs, packed)
        y_ref = stage4_resident_reference(ob, xs, packed)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = ulp_tol(y_ref.float(), 2)
        ms = cuda_ms(lambda: stage4_resident(ob, xs, packed))
        plain_ms = cuda_ms(lambda: stage4_resident_reference(ob, xs, packed),
                           iters=3, warmup=1)
        m = b * 49
        weights = c1 * c + cin * c + 2 * (c * c1 + 9 * c1 * c1 + c1 * c)
        vectors = (2 * c + 2 * 2 * c1 + 2 * c + 3 * 12 * c) * 4
        nbytes = 2 * weights + 2 * m * (c1 + cin + c) + vectors
        bound_ms, by = bound(nbytes, 2 * m * weights,
                             3 * TAIL_FP32_OPS * m * c)
        rows[shape] = dict(
            shape=f"{stage} ob [{b},7,7,{c1}] xs [{b},7,7,{cin}] -> "
                  f"[{b},7,7,{c}]", max_abs_err=err, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        print(f"stage4 {rows[shape]['shape']} bf16: max|Δy| {err:.3g} (tol "
              f"{tol:.3g}: 2 bf16 ulps at max|y| = "
              f"{y_ref.float().abs().max().item():.3g}; y's own rounding of "
              f"fp32 sums taken in another order, plus the rare one-ulp "
              f"flips of the bf16 y, x1 and o that travel on) | kernel "
              f"{ms:.4f} ms ({2 * m * weights / ms / 1e9:.1f} TFLOP/s), "
              f"bound {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"stage4: {err} > {tol}")
    return rows


RESNET_PATHS = {False: "use_stage4=False", True: "use_stage4=True"}
DEIT_PATH = "deit_mrlal_small"


def all_counters():
    """Every kernel wrapper's launch counter, by the kernels line's key."""
    from mrla_tpu_torch.kernels import (
        deit_token_tail,
        fused_block_tail,
        fused_epilogue,
        hwbc_copy,
        mrla_block_tail_fused_next,
        mrla_block_tail_hwbc,
        mrla_rowtail,
        roi_align_patch,
        stage4_resident,
    )

    return {"megatail": mrla_block_tail_fused_next.counter,
            "epilogue": fused_epilogue.counter,
            "stage4": stage4_resident.counter,
            "deit_tail": deit_token_tail.counter,
            "roi_align": roi_align_patch.counter,
            "block_tail": fused_block_tail.counter,
            "block_tail_hwbc": mrla_block_tail_hwbc.counter,
            "rowtail": mrla_rowtail.counter,
            "copy": hwbc_copy.counter}


def check_logits_out(out) -> None:
    if out.shape != (BATCH, 1000) or not torch.isfinite(out).all():
        raise AssertionError("logits not finite or of the wrong shape")


def counted(forward, batches, route: str, want: dict,
            check_out=check_logits_out, desc=f"{PX}px bs{BATCH} bf16"):
    """Drive a main path: every wrapper's counts are set to 0 just before
    the requests and read just after.  The launches per forward by shape
    must be exactly ``want``, and ``check_out`` must pass on every output.
    Returns (outputs, launches, launches per forward by shape)."""
    counters = all_counters()
    for c in counters.values():
        c.reset()
    outs = [forward(xb) for xb in batches]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    per_forward = {k: {s: n / len(batches) for s, n in c.by_shape.items()}
                   for k, c in counters.items()}
    print(f"serving {route}, {desc}, {len(batches)} requests: "
          f"launches {launches}; per forward by shape {per_forward}")
    if per_forward != want:
        raise AssertionError(f"{route}: launches per forward "
                             f"{per_forward} != {want}")
    for out in outs:
        try:
            check_out(out)
        except AssertionError as e:
            raise AssertionError(f"{route}: {e}") from None
    return outs, launches, per_forward


def throughput(forward, batches, route: str, smi: str,
               consume=lambda out: out.sum(), batch=BATCH,
               desc=f"{PX}px bs{BATCH} bf16"):
    """img/s of ``forward`` over TIMED_FORWARDS forwards ending in a
    synchronize, after two, every output consumed; and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    total = torch.zeros((), device="cuda")
    for xb in batches[:2]:
        total += consume(forward(xb))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_FORWARDS):  # every output consumed
        total += consume(forward(batches[i % len(batches)]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(total):
        raise AssertionError("non-finite outputs in the timed run")
    print(f"throughput {route}, {desc}: "
          f"{TIMED_FORWARDS * batch / dt:.1f} img/s "
          f"({dt / TIMED_FORWARDS * 1e3:.2f} ms/forward over "
          f"{TIMED_FORWARDS} forwards), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, on {smi}")


def serve(smi: str):
    from mrla_tpu_torch.serving import (
        attach_stage4,
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.testing import images, serving_model

    model = serving_model(0)
    params = attach_stage4(prepare_inference_params(
        model, dtype=torch.bfloat16, device="cuda"))
    gen = torch.Generator().manual_seed(1)
    host_batches = [images(gen, BATCH, PX) for _ in range(REQUESTS)]
    batches = [xb.cuda() for xb in host_batches]
    tables = {k: {} for k in all_counters()}
    tables.update(megatail=MEGATAIL_SHAPES, epilogue=EPILOGUE_SHAPES,
                  stage4=STAGE4_SHAPES)
    stage4_epilogues = {s: v for s, v in EPILOGUE_SHAPES.items()
                        if v[0] == "stage4"}
    with torch.no_grad():
        ref = model(host_batches[0][:32])  # the port's fp32 CPU forward

    def forward(use_stage4):
        return lambda xb: resnet_mrlal_forward(params, xb,
                                               use_stage4=use_stage4)

    launches, per_forward = {}, {}
    for use_stage4 in (False, True):
        route = RESNET_PATHS[use_stage4]
        want = {k: {s: n for s, (_, n) in table.items()}
                for k, table in tables.items()}
        if use_stage4:
            for s in stage4_epilogues:
                del want["epilogue"][s]
        else:
            want["stage4"] = {}
        logits, launches[route], per_forward[route] = counted(
            forward(use_stage4), batches, f"resnet50_mrlal {route}", want)
        check_logits(ref, logits[0][:32].cpu(), route, LOGIT_ERROR_TOL)
        check_faults(params, host_batches[0][:32].cuda(), ref, use_stage4)

    for use_stage4 in (False, True, True, False):  # in turns, on one card
        throughput(forward(use_stage4), batches,
                   f"resnet50_mrlal {RESNET_PATHS[use_stage4]}", smi)
    tail_launches, tail_per_forward = serve_tail_routes(
        params, batches, host_batches, ref, forward(False), smi)
    launches.update(tail_launches)
    per_forward.update(tail_per_forward)
    return launches, per_forward


def serve_tail_routes(params, batches, host_batches, ref, default, smi):
    """The three tail routes (serving/tail_routes.py) on the serving params
    of serve(): counted requests, the logit check against the same fp32 CPU
    forward with one injected fault per route, the copy route bitwise equal
    to the block-tail route, and img/s in turns with the default route."""
    from mrla_tpu_torch.serving import resnet_mrlal_tail_forward

    def forward(tail):
        return lambda xb: resnet_mrlal_tail_forward(params, xb, tail)

    launches, per_forward, logits = {}, {}, {}
    for tail, table in TAIL_TABLES.items():
        route = TAIL_PATHS[tail]
        want = {k: {} for k in all_counters()}
        for key, shapes in table.items():
            want[key] = {s: n for s, (_, n) in shapes.items()}
        logits[tail], launches[route], per_forward[route] = counted(
            forward(tail), batches, f"resnet50_mrlal {route}", want)
        check_logits(ref, logits[tail][0][:32].cpu(), route, LOGIT_ERROR_TOL)
    same = all(torch.equal(a, b) for a, b in zip(logits["copy"],
                                                 logits["block_tail"]))
    print(f"tail route copy: logits of the {len(batches)} requests "
          f"{'bitwise equal to' if same else 'DIFFER from'} the block_tail "
          f"route's")
    if not same:
        raise AssertionError("the copy route changes the logits")
    del logits

    x32 = host_batches[0][:32].cuda()
    errs = {f"{tail} {kind}@{at}": logit_error(
        faulty_tail_forward(params, x32, tail, kind, at), ref)
        for tail, faults in TAIL_FAULTS.items() for kind, at in faults}
    print("logit error with one wiring fault on a tail route (route "
          "kind@block or @copy): " + ", ".join(f"{k} {v:.4g}"
                                               for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")

    turns = [(RESNET_PATHS[False], default)] + [
        (route, forward(tail)) for tail, route in TAIL_PATHS.items()]
    for route, fn in turns + turns[::-1]:  # in turns, on one card
        throughput(fn, batches, f"resnet50_mrlal {route}", smi)
    return launches, per_forward


def faulty_tail_forward(params, x, tail: str, kind: str, at: int):
    """A tail route with one wiring fault (TAIL_FAULTS) at call ``at`` of
    its kernel wrapper."""
    import mrla_tpu_torch.serving.tail_routes as routes

    saved = {k: getattr(routes, k) for k in (
        "mrla_rowtail", "mrla_block_tail", "mrla_block_tail_hwbc",
        "hwbc_copy")}
    calls = itertools.count()

    def no_id(out, identity, *rest):
        if next(calls) == at:
            identity = torch.zeros_like(identity)
        return saved["mrla_rowtail"](out, identity, *rest)

    def swapped(name):
        def tail_fn(z, identity, *rest):
            if next(calls) == at:
                z, identity = identity, z
            return saved[name](z, identity, *rest)
        return tail_fn

    previous = []

    def stale(y):
        i = next(calls)
        previous.append(y)
        return saved["hwbc_copy"](previous[i - 1] if i == at else y)

    if kind == "no_id":
        routes.mrla_rowtail = no_id
    elif kind == "swap":
        routes.mrla_block_tail = swapped("mrla_block_tail")
        routes.mrla_block_tail_hwbc = swapped("mrla_block_tail_hwbc")
    else:
        routes.hwbc_copy = stale
    try:
        return routes.resnet_mrlal_tail_forward(params, x, tail).cpu()
    finally:
        for k, v in saved.items():
            setattr(routes, k, v)


def serve_deit(smi: str):
    """The DeiT main path: serving, the logit check with its four injected
    faults, and throughput.  Returns (launches, launches per forward by
    shape) of the four requests, keyed as serve()'s."""
    from mrla_tpu_torch.serving import (
        deit_forward,
        prepare_deit_inference_params,
    )
    from mrla_tpu_torch.testing import deit_serving_model, images

    model = deit_serving_model(DEIT_ARCH, 0)
    params = prepare_deit_inference_params(model, device="cuda",
                                           dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    host_batches = [images(gen, BATCH, PX) for _ in range(REQUESTS)]
    batches = [xb.cuda() for xb in host_batches]
    with torch.no_grad():
        ref = model(host_batches[0][:32])  # the port's fp32 CPU forward

    forward = lambda xb: deit_forward(params, xb)
    want = {k: {} for k in all_counters()}
    want["deit_tail"] = {s: n for s, (_, n) in DEIT_TAIL_SHAPES.items()}
    logits, launches, per_forward = counted(forward, batches, DEIT_ARCH, want)
    check_logits(ref, logits[0][:32].cpu(), DEIT_PATH, DEIT_LOGIT_ERROR_TOL)
    x32 = host_batches[0][:32].cuda()
    errs = {kind: logit_error(faulty_deit_forward(params, x32, kind), ref)
            for kind in DEIT_FAULTS}
    print(f"logit error with {DEIT_PATH}, one wiring fault in every block: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > DEIT_LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")

    for _ in range(2):
        throughput(forward, batches, DEIT_ARCH, smi)
    return launches, per_forward


# ot: the tail's ot taken after the attention residual, not the block input;
# next: block i's tail run with block i + 1's packed params (the last with
# the first's); cls: the cls row sent through the MRLA branch as a grid
# token without neighbours; heads: the gate's heads shifted by one
DEIT_FAULTS = ("ot", "next", "cls", "heads")


def faulty_deit_forward(params, x, kind: str) -> torch.Tensor:
    """The DeiT engine with one wiring fault (DEIT_FAULTS) in every block.
    The grid rows of the last block never reach the logits, so a fault in
    one block alone could go unseen by construction."""
    import torch.nn.functional as F

    import mrla_tpu_torch.serving.deit as eng
    from mrla_tpu_torch.kernels.deit_token_tail import tail_terms

    block, tail = eng._block, eng.deit_token_tail
    blocks = params["blocks"]

    def faulty_block(x, p, heads, d):
        y = F.linear(eng._layer_norm(x, *p["norm1"]), *p["qkv"])
        x1 = F.linear(eng.attention(y, heads), *p["proj"]).add_(x)
        y = F.gelu(F.linear(eng._layer_norm(x1, *p["norm2"]), *p["fc1"]))
        return tail(F.linear(y, *p["fc2"]).add_(x1), x1, p["tail"], d)

    def faulty_tail(x, ot, packed, d):
        if kind == "next":
            at = next(i for i, p in enumerate(blocks) if p["tail"] is packed)
            return tail(x, ot, blocks[(at + 1) % len(blocks)]["tail"], d)
        x32, normx, normo, gate, v = tail_terms(x, ot, packed, d)
        lam = packed.vec[4]
        if kind == "heads":
            gate = gate.roll(d, dims=-1)
        cls = x32[:, :1] + normx[:, :1]
        if kind == "cls":  # the centre tap alone: no neighbours
            cls = (x32[:, :1] + F.gelu(normx[:, :1] * packed.vec[9])
                   * gate[:, None] + lam * normo[:, :1])
        grid = x32[:, 1:] + v * gate[:, None] + lam * normo[:, 1:]
        return torch.cat([cls, grid], dim=1).to(x.dtype)

    if kind == "ot":
        eng._block = faulty_block
    else:
        eng.deit_token_tail = faulty_tail
    try:
        return eng.deit_forward(params, x).cpu()
    finally:
        eng._block, eng.deit_token_tail = block, tail


def logit_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| over the part of ``ref`` that differs from image to
    image, ||ref - its mean over the images||.  With random weights most of
    each logit is shared by every image, so an error measured against the
    logits themselves would hide a fault that leaves that share in place."""
    return ((got - ref).norm() / (ref - ref.mean(0)).norm()).item()


def faulty_forward(params, x, kind: str, at: int) -> torch.Tensor:
    """The serving engine with one wiring fault in block ``at`` (its tail
    call): ``handoff`` passes on x1 = relu(conv1(out)) of the block's map
    before the tail instead of conv1 of y; ``identity`` gives the tail the
    block's own map as its identity."""
    import mrla_tpu_torch.serving.resnet_mrlal as eng

    tail, epi = eng.mrla_block_tail_fused_next, eng.mrla_light_epilogue
    calls = itertools.count()

    def faulty_tail(out, identity, *rest):
        hit = next(calls) == at
        y, x1 = tail(out, out if hit and kind == "identity" else identity,
                     *rest)
        if hit and kind == "handoff":
            x1 = eng._conv(out, rest[-2], rest[-1]).relu_()
        return y, x1

    def faulty_epi(out, identity, *rest):
        hit = next(calls) == at
        return epi(out, out if hit and kind == "identity" else identity,
                   *rest)

    eng.mrla_block_tail_fused_next, eng.mrla_light_epilogue = (faulty_tail,
                                                              faulty_epi)
    try:
        return eng.resnet_mrlal_forward(params, x).cpu()
    finally:
        eng.mrla_block_tail_fused_next, eng.mrla_light_epilogue = tail, epi


def faulty_stage4_forward(params, x, kind: str) -> torch.Tensor:
    """The use_stage4=True engine with one fault at the stage kernel:
    ``swapped`` packs blocks 1 and 2 in each other's place; ``xs`` hands the
    kernel the odd pixels x[:, 1::2, 1::2, :] of the stage's input."""
    import mrla_tpu_torch.serving.resnet_mrlal as eng
    from mrla_tpu_torch.kernels import pack_stage4_params

    kernel, packed = eng.stage4_resident, params["stage4"]

    def odd_pixels(ob, xs, p):
        shift = (xs.stride(1) + xs.stride(2)) // 2  # one row and one column
        return kernel(ob, xs.as_strided(xs.shape, xs.stride(),
                                        xs.storage_offset() + shift), p)

    if kind == "swapped":
        b0, b1, b2 = params["blocks"][-3:]
        params["stage4"] = pack_stage4_params([b0, b2, b1],
                                              dtype=b0["k3"].dtype)
    else:
        eng.stage4_resident = odd_pixels
    try:
        return eng.resnet_mrlal_forward(params, x, use_stage4=True).cpu()
    finally:
        eng.stage4_resident, params["stage4"] = kernel, packed


def check_logits(ref, got, route: str, tol: float):
    """The served bf16 logits of 32 images against the port's own fp32
    forward on the CPU: top-1 on the 8 clearest images, and logit_error
    within ``tol``."""
    # A random 1000-way head puts some images on a near tie, where the top-1
    # class is decided by rounding; the 8 with the largest fp32 top-1
    # margin are compared.
    top2 = ref.topk(2, dim=-1).values
    margins = top2[:, 0] - top2[:, 1]
    pick = margins.argsort(descending=True)[:8]
    err = logit_error(got, ref)
    print(f"{route}: top-1 vs the port's fp32 CPU forward on the 8 clearest "
          f"of 32 images: bf16 {got[pick].argmax(-1).tolist()} fp32 "
          f"{ref[pick].argmax(-1).tolist()}; least margin of the 8 "
          f"{margins[pick].min().item():.4g}; top-1 agrees on "
          f"{(got.argmax(-1) == ref.argmax(-1)).sum().item()}/32; max|Δlogit|"
          f" {(got - ref).abs().max().item():.4g}, max|logit| "
          f"{ref.abs().max().item():.4g}; logit error {err:.4g} (tol "
          f"{tol})")
    if not torch.equal(got[pick].argmax(-1), ref[pick].argmax(-1)):
        raise AssertionError(f"{route}: top-1 disagrees with the fp32 CPU "
                             "forward")
    if not err <= tol:
        raise AssertionError(f"{route}: logit error {err} > {tol}")


def check_faults(params, x, ref, use_stage4: bool):
    """The same logit check on the engine with one wiring fault: on the
    per-block route, every block and both faults; on the stage-kernel
    route, the two faults at the stage kernel.  Each must fail the check,
    or the check could not see such a fault."""
    if use_stage4:
        errs = {kind: logit_error(faulty_stage4_forward(params, x, kind), ref)
                for kind in ("swapped", "xs")}
        label = "use_stage4=True, one fault at the stage kernel"
    else:
        faults = [("handoff", i) for i in range(
            sum(n for _, n in MEGATAIL_SHAPES.values()))]
        faults += [("identity", i) for i in range(len(params["blocks"]))]
        errs = {f"{kind}@{at}": logit_error(
            faulty_forward(params, x, kind, at), ref) for kind, at in faults}
        label = "use_stage4=False, one wiring fault (kind@block)"
    print(f"logit error with {label}: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")


def roi_axes(hw, b, geom, out_size: int, smax: int):
    """Each roi's two axis tables as the kernels build them (cells and
    weights of every bin and sample slot, detect/roi_align.py:axis_samples),
    with its level, image and validity."""
    from mrla_tpu_torch.detect.roi_align import axis_samples

    g = geom.reshape(-1, geom.shape[-1])
    p = geom.shape[1]
    lvl = g[:, 7].long()
    img = torch.arange(b, device=g.device).repeat_interleave(p)
    hs = torch.tensor([h for h, _ in hw], device=g.device)
    ws = torch.tensor([w for _, w in hw], device=g.device)
    ys = axis_samples(g[:, 0], g[:, 2], g[:, 4], hs[lvl], out_size, smax)
    xs = axis_samples(g[:, 1], g[:, 3], g[:, 5], ws[lvl], out_size, smax)
    return ys, xs, lvl, img, g[:, 6] > 0


def footprint_cells(hw, b, geom, out_size: int, smax: int) -> int:
    """Pyramid cells the rois' samples touch with a weight: the union over
    the valid rois of each roi's touched rows x touched columns."""
    (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi), lvl, img, valid = \
        roi_axes(hw, b, geom, out_size, smax)
    rows = torch.cat([torch.where(wylo > 0, ylo, -1),
                      torch.where(wyhi > 0, yhi, -1)], -1).flatten(1)
    cols = torch.cat([torch.where(wxlo > 0, xlo, -1),
                      torch.where(wxhi > 0, xhi, -1)], -1).flatten(1)
    cells = 0
    for lv, (h, w) in enumerate(hw):
        m = valid & (lvl == lv)
        r, c, i = rows[m][:, :, None], cols[m][:, None, :], img[m]
        keep = (r >= 0) & (c >= 0)
        i = i[:, None, None].expand_as(keep)
        canvas = torch.zeros(b, h, w, dtype=torch.bool, device=geom.device)
        canvas[i[keep], r.expand_as(keep)[keep], c.expand_as(keep)[keep]] = 1
        cells += int(canvas.sum())
    return cells


def roi_work(feats, geom, out_size: int, smax: int, out_bytes: int):
    """(bytes, fp32 operations) that one RoIAlign over ``geom`` needs on
    this data: the pyramid cells the rois' samples touch read once, the
    output written once, the geometry read once; 4 corners x (multiply,
    add) per live sample and channel."""
    b, c = feats[0].shape[0], feats[0].shape[-1]
    hw = [tuple(f.shape[1:3]) for f in feats]
    (_, _, wylo, wyhi), (_, _, wxlo, wxhi), _, _, valid = \
        roi_axes(hw, b, geom, out_size, smax)
    n_y = ((wylo + wyhi) > 0).flatten(1).sum(1).double()
    n_x = ((wxlo + wxhi) > 0).flatten(1).sum(1).double()
    ops = (valid * n_y * n_x).sum().item() * c * ROI_FP32_OPS
    cells = footprint_cells(hw, b, geom, out_size, smax)
    nbytes = (cells * c * feats[0].element_size()
              + geom.shape[0] * geom.shape[1] * out_size ** 2 * c * out_bytes
              + geom.numel() * 4)
    return nbytes, ops


def grad_work(hw, b, c, geom, out_size: int, smax: int):
    """(bytes, fp32 operations) that one RoIAlign backward over ``geom``
    needs on this data: the valid rois' fp32 cotangent read once, the fp32
    gradient buffers written once, the geometry read once (what the kernel
    writes and reads again, its scratch and the rows of rois that meet
    several tiles, is its cost, not the function's); per valid roi, bin,
    channel and pair of distinct (y, x) cells of the bin one multiply and
    one add."""
    (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi), _, _, valid = \
        roi_axes(hw, b, geom, out_size, smax)

    def distinct(lo, hi, wlo, whi):  # [R, O]: cells with weight, per bin
        cells = torch.cat([torch.where(wlo > 0, lo, -1),
                           torch.where(whi > 0, hi, -1)], -1).sort(-1).values
        new = torch.ones_like(cells, dtype=torch.bool)
        new[..., 1:] = cells[..., 1:] != cells[..., :-1]
        return (new & (cells >= 0)).sum(-1).double()

    n_y = distinct(ylo, yhi, wylo, wyhi).sum(1)
    n_x = distinct(xlo, xhi, wxlo, wxhi).sum(1)
    pairs = (valid * n_y * n_x).sum().item()
    buffers = sum(b * h * w for h, w in hw) * c * 4
    nbytes = (int(valid.sum()) * out_size ** 2 * c * 4 + buffers
              + geom.numel() * 4)
    return nbytes, 2 * pairs * c


def library_roi_align_ms(feats, geom, out_size: int, strides):
    """torchvision.ops.roi_align per level (aligned, adaptive grid) on the
    same rois, where torchvision is installed; else None.  A yardstick
    only: the port never calls it."""
    try:
        from torchvision.ops import roi_align
    except ImportError:
        return None
    g = geom.reshape(-1, geom.shape[-1])
    p = geom.shape[1]
    img = torch.arange(feats[0].shape[0], device=g.device).repeat_interleave(p)
    per_level = []
    for lv, (f, st) in enumerate(zip(feats, strides)):
        m = g[:, 7] == lv
        y1, x1 = g[m, 0] + 0.5, g[m, 1] + 0.5  # back to image coordinates
        y2 = y1 + g[m, 2] * out_size
        x2 = x1 + g[m, 3] * out_size
        boxes = torch.stack([img[m].float(), x1 * st, y1 * st, x2 * st,
                             y2 * st], 1)
        per_level.append((f.permute(0, 3, 1, 2), boxes, 1.0 / st))
    return cuda_ms(lambda: [roi_align(f, bx, out_size, sc, 0, True)
                            for f, bx, sc in per_level])


def check_roi_align(params):
    """The RoIAlign kernel against its plain version on the rois the
    detection path makes from seeded images: the proposals of the box head
    (8 x 1000, 7 x 7) and the detections of the mask head (8 x 100,
    14 x 14), through the wrapper in the path's bf16 form, and through the
    launcher in the fp32 form; both held to the plain version in fp32."""
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_reference,
        roi_geometry,
    )
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.kernels.roialign_patch import (
        roi_align_kernel,
        roi_align_patch,
    )
    from mrla_tpu_torch.serving import two_stage_detections
    from mrla_tpu_torch.testing import images

    roi_inputs = []  # (feats, rois, valid, out) of each RoIAlign stage

    def keep_roi_inputs(name, fn, *args, **kw):
        if name.startswith("RoIAlign"):
            roi_inputs.append(args)
        return fn(*args, **kw)

    x = images(torch.Generator().manual_seed(4), DET_BATCH, DET_HW).to("cuda")
    two_stage_detections(params, x, MASK_PRESET, stage=keep_roi_inputs)
    feats = roi_inputs[0][0]
    pyramid = [f.contiguous() for f in feats[:4]]
    pyramid32 = [f.float() for f in pyramid]
    cases = {next(iter(ROI_SHAPES)): roi_inputs[0][1:],
             next(iter(MASK_ROI_SHAPES)): roi_inputs[1][1:]}
    rows = {}
    for shape, (rois, rv, o) in cases.items():
        label = {**ROI_SHAPES, **MASK_ROI_SHAPES}[shape][0]
        got = roi_align_patch(pyramid, rois, rv, ROI_STRIDES, o, 0)
        geom, smax = roi_geometry(rois, rv, [f.shape[1:3] for f in pyramid],
                                  ROI_STRIDES, o, 0)
        want = roi_align_reference(pyramid32, geom, o, smax)
        err = (got.float() - want).abs().max().item()
        tol = ulp_tol(want, 1)
        got32 = roi_align_kernel(pyramid32, geom, o, smax)
        err32 = (got32 - want).abs().max().item()
        tol32 = ROI_FP32_TERMS * 2.0 ** -24 * max(
            f.abs().max().item() for f in pyramid32)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: roi_align_kernel(pyramid, geom, o, smax))
        ms32 = cuda_ms(lambda: roi_align_kernel(pyramid32, geom, o, smax))
        plain_ms = cuda_ms(lambda: roi_align_reference(pyramid, geom, o, smax),
                           iters=3, warmup=1)
        nbytes, ops = roi_work(pyramid, geom, o, smax, 2)
        bound_ms, by = bound(nbytes, 0, ops)
        lib_ms = library_roi_align_ms(pyramid, geom, o, ROI_STRIDES)
        g = geom.reshape(-1, geom.shape[-1])
        live = g[:, 6] > 0
        levels = torch.bincount(g[live, 7].long(), minlength=4).tolist()
        mean_g = (g[live, 4] * g[live, 5]).mean().item()
        rows[shape] = dict(
            shape=f"{label} [{shape[0]},{shape[1]}] rois, out {o}x{o}, "
                  f"C {shape[3]}", max_abs_err=max(err, err32), tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms, fp32_ms=ms32)
        print(f"roi_align {label} {list(got.shape)}: valid rois "
              f"{int(live.sum())}, by level {levels}, mean gy*gx "
              f"{mean_g:.2f}; bf16 max|Δ| {err:.3g} (tol {tol:.3g}: 1 bf16 "
              f"ulp at max|out| = {want.abs().max().item():.3g}; both round "
              f"one fp32 value summed in another order); fp32 max|Δ| "
              f"{err32:.3g} (tol {tol32:.3g}: {ROI_FP32_TERMS} fp32 "
              f"roundings of max|feature|) | kernel {ms:.4f} ms (fp32 "
              f"{ms32:.4f}), bound {bound_ms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'n/a (no torchvision)' if lib_ms is None else lib_ms}")
        if not (err <= tol and err32 <= tol32):
            raise AssertionError(f"roi_align {label}: bf16 {err} > {tol} or "
                                 f"fp32 {err32} > {tol32}")
        del got, got32, want
    return rows


def check_detections(out) -> None:
    boxes, scores, labels, valid = out[:4]
    b, m = DET_BATCH, 100
    if (boxes.shape != (b, m, 4) or scores.shape != (b, m)
            or labels.shape != (b, m) or valid.shape != (b, m)):
        raise AssertionError("detections of the wrong shape")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("detections not finite")
    if valid.sum(1).min() < 1:
        raise AssertionError(f"an image without detections: "
                             f"{valid.sum(1).tolist()}")
    if len(out) > 4 and (out[4].shape != (b, m, 28, 28)
                         or not torch.isfinite(out[4]).all()):
        raise AssertionError("masks not finite or of the wrong shape")


def rel_err(got, ref) -> float:
    return ((got.float().cpu() - ref).norm() / ref.norm()).item()


def det_errors(params, x2, ref) -> dict:
    """The served bf16 path on 2 images against the port's fp32 forward on
    the CPU (``ref``: the module's outputs and its RoI features ``roi``):
    the pyramid (largest relative error of P2..P6), the RoI features on
    the CPU's proposals (relative), and the box head's
    (cls, reg) on them, relative to their roi-dependent part (with random
    weights much of each output is shared by every roi)."""
    from mrla_tpu_torch.serving import detect as det

    with torch.inference_mode():
        feats = det.detect_forward(params, x2)
        pyramid = max(rel_err(g, r) for g, r in zip(feats, ref["feats"]))
        props = ref["proposals"].to("cuda")
        pvalid = ref["proposal_valid"].to("cuda")
        roi = det.roi_feats(feats, props, pvalid, 7)
        cls, reg = det.bbox_head(params["bbox_head"], roi)
        head = max(
            ((g.float().cpu() - r).norm() / (r - r.mean(1, keepdim=True))
             .norm()).item()
            for g, r in ((cls, ref["cls"]), (reg, ref["reg"])))
        return {"pyramid": pyramid, "roi": rel_err(roi, ref["roi"]),
                "head": head}


# flatten: the box head's first fc in mmdet's [C, 7, 7] column order on
# NHWC-flattened RoI features; xy: rois with x and y swapped; level: the
# level mapping one level up; fpn_add: the top-down add into P4 left out
DET_FAULTS = {"flatten": "head", "xy": "roi", "level": "roi",
              "fpn_add": "pyramid"}


def faulty_det_errors(params, x2, ref, model, kind: str) -> dict:
    """det_errors of the served path with one wiring fault (DET_FAULTS)."""
    import mrla_tpu_torch.detect.fpn as fpn_mod
    import mrla_tpu_torch.detect.roi_align as ra
    import mrla_tpu_torch.serving.detect as det

    roi_feats, levels, up = det.roi_feats, ra.map_roi_levels, \
        fpn_mod.upsample_nearest_to
    p = params
    if kind == "flatten":
        w0 = model.roi_head.bbox_head.shared_fcs[0].weight
        p = {**params, "bbox_head": {
            **params["bbox_head"],
            "fc0": (w0.detach().to("cuda", torch.bfloat16).contiguous(),
                    params["bbox_head"]["fc0"][1])}}
    elif kind == "xy":
        det.roi_feats = lambda feats, rois, *a: roi_feats(
            feats, rois[..., [1, 0, 3, 2]], *a)
    elif kind == "level":
        ra.map_roi_levels = lambda rois, n, *a: (
            levels(rois, n, *a) + 1).clamp(max=n - 1)
    else:
        calls = itertools.count()
        fpn_mod.upsample_nearest_to = lambda x, h, w: (
            up(x, h, w) * (0.0 if next(calls) == 0 else 1.0))
    try:
        return det_errors(p, x2, ref)
    finally:
        det.roi_feats, ra.map_roi_levels = roi_feats, levels
        fpn_mod.upsample_nearest_to = up


def serve_detect(smi: str):
    """The detection main paths: the RoIAlign kernel check on the path's
    rois, the counted requests of both presets, the check against the fp32
    CPU forward with its four injected faults, and throughput.  Returns
    (RoIAlign rows, launches, launches per forward by shape) keyed by
    path."""
    from mrla_tpu_torch.serving import (
        prepare_detect_params,
        two_stage_detections,
    )
    from mrla_tpu_torch.testing import detector_serving_model, images

    t0 = time.perf_counter()
    # one seeded Mask R-CNN: the faster preset runs its box path
    model = detector_serving_model(0, MASK_PRESET)
    params = prepare_detect_params(model, dtype=torch.bfloat16,
                                   device="cuda")
    gen = torch.Generator().manual_seed(3)
    host = [images(gen, DET_BATCH, DET_HW) for _ in range(DET_REQUESTS)]
    batches = [xb.to("cuda") for xb in host]
    t1 = time.perf_counter()
    with torch.no_grad():
        ref = model(host[0][:2])  # the port's fp32 CPU forward
        ref["roi"] = model.roi_feats(ref["feats"], ref["proposals"],
                                     ref["proposal_valid"])
    print(f"detector: seeded and spread in {t1 - t0:.1f} s; fp32 CPU "
          f"forward of 2 images in {time.perf_counter() - t1:.1f} s")

    rows = check_roi_align(params)
    desc = f"{DET_HW[0]}x{DET_HW[1]} bs{DET_BATCH} bf16"
    launches, per_forward = {}, {}
    for path, preset, extra in ((DET_PATH, DET_PRESET, {}),
                                (MASK_PATH, MASK_PRESET, MASK_ROI_SHAPES)):
        want = {k: {} for k in all_counters()}
        want["megatail"] = {s: n for s, (_, n) in DET_MEGATAIL_SHAPES.items()}
        want["epilogue"] = {s: n for s, (_, n) in DET_EPILOGUE_SHAPES.items()}
        want["roi_align"] = {s: n for s, (_, n) in
                             {**ROI_SHAPES, **extra}.items()}
        outs, launches[path], per_forward[path] = counted(
            lambda xb, preset=preset: two_stage_detections(params, xb,
                                                           preset),
            batches, path, want, check_detections, desc)
        print(f"{path}: detections per image {outs[0][3].sum(1).tolist()}, "
              f"labels of image 0 {outs[0][2][0, :8].tolist()}, scores "
              f"{[round(v, 3) for v in outs[0][1][0, :4].tolist()]}")
        del outs

    x2 = host[0][:2].to("cuda")
    errs = det_errors(params, x2, ref)
    print(f"{DET_PATH} against the fp32 CPU forward (2 images): "
          + ", ".join(f"{k} {v:.4g} (tol {DET_TOLS[k]})"
                      for k, v in errs.items()))
    over = [k for k, v in errs.items() if not v <= DET_TOLS[k]]
    if over:
        raise AssertionError(f"{DET_PATH}: {over} beyond tolerance")
    for kind, metric in DET_FAULTS.items():
        fe = faulty_det_errors(params, x2, ref, model, kind)
        print(f"{DET_PATH} with the fault {kind}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in fe.items()))
        if not fe[metric] > DET_TOLS[metric]:
            raise AssertionError(f"the {metric} check misses the fault "
                                 f"{kind}")

    for path, preset in ((DET_PATH, DET_PRESET), (MASK_PATH, MASK_PRESET),
                         (MASK_PATH, MASK_PRESET), (DET_PATH, DET_PRESET)):
        throughput(lambda xb, preset=preset: two_stage_detections(
            params, xb, preset), batches, path, smi,
            consume=lambda out: out[1].sum(), batch=DET_BATCH, desc=desc)
    return rows, launches, per_forward


# The detection training path: the two-stage presets through the trainer
# entry point (detect/train_cli.py) at 800 x 800, batch 8, 80 classes, fp32
# (TF32 off), seeded weights.  Per step the RoIAlign wrapper launches,
# keyed (B, P, out, C) forward and ("bwd", B, P, out, C) backward: the box
# head's 512 sampled rois; with masks the mask head's first 128 and the gt
# mask crop (one level, stride 1, the gt axis as channels, fp32 canvas).
TRAIN_PATH = "faster_rcnn_r50mrlal training"
TRAIN_BATCH, TRAIN_PX, TRAIN_MAX_GT = 8, 800, 32
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
TRAIN_ROI = {(TRAIN_BATCH, 512, 7, 256): "box head"}
TRAIN_MASK_ROI = {(TRAIN_BATCH, 128, 14, 256): "mask head",
                  (TRAIN_BATCH, 128, 28, TRAIN_MAX_GT): "gt mask crop"}
# each cell of the backward sums at most a few hundred weighted cotangent
# terms, in another order than the plain version's: 64 fp32 roundings of
# the sum of its terms' magnitudes, cell by cell (test_torch_gpu.py holds
# the same)
GRAD_ROUNDINGS = 64
# the in-situ step: full depth, 800 x 800, batch 2.  Card against CPU, both
# fp32: the loss terms relative, the gradient of the R-CNN loss to each of
# P2..P5 relative to its norm.  The gradient reads about 1e-3 where the loss
# terms agree to 1e-7: box-head ReLUs whose input lies within fp32 noise of
# 0 switch between the two, each moving the gradient by its share (the
# card with the plain backward reads the same, printed beside).  Limits
# between the sound reading and the least injected fault (both printed by
# this script; readings in PERF.md).
INSITU_PX, INSITU_BATCH = 800, 2
INSITU_TOLS = {"loss": 1e-3, "grad": 0.02}
# the wrapper's autograd on the card against the CPU: a function linear in
# the features, so the two differ only by the order of fp32 sums (relative
# norm about 2e-6); the valid-ignored fault reads near 0.6
AUTOGRAD_TOL = 1e-4
# backward faults: x and y swapped, the gradient sent one level up, the
# cotangent dropped (in situ); valid ignored (the autograd check: in situ
# the loss gives an unsampled roi a zero cotangent, so it cannot show there)
GRAD_FAULTS = ("xy", "level", "dropped")
# the learning check: a small detector on the synthetic squares task
LEARN_ARGV = ["--preset", DET_PRESET, "--backbone-layers", "1", "1", "1",
              "1", "--img-size", "128", "--num-classes", "3", "--max-gt",
              "4", "--batch-size", "8", "--epochs", "2", "--steps-per-epoch",
              "150", "--eval-steps", "3", "--rpn-proposals", "100",
              "--rcnn-samples", "64", "--warmup-iters", "100", "--lr",
              "0.005", "--eval-every", "2"]
LEARN_WINDOW = 20  # steps averaged at the start and at the end
# the mean loss of the last LEARN_WINDOW steps over that of the first
LEARN_RATIO_TOL = 0.6


def split_roi_counts(counter, steps: int):
    """(launches, launches per step by shape) of the RoIAlign counter,
    apart for the forward ("roi_align") and the backward
    ("roi_align_bwd")."""
    fwd = {s: n for s, n in counter.by_shape.items() if s[0] != "bwd"}
    bwd = {s: n for s, n in counter.by_shape.items() if s[0] == "bwd"}
    return ({"roi_align": sum(fwd.values()),
             "roi_align_bwd": sum(bwd.values())},
            {"roi_align": {s: n / steps for s, n in fwd.items()},
             "roi_align_bwd": {s: n / steps for s, n in bwd.items()}})


def train_argv(preset: str, steps: int, extra=()):
    """train_cli's arguments for the full-width training path."""
    return ["--preset", preset, "--img-size", str(TRAIN_PX), "--batch-size",
            str(TRAIN_BATCH), "--num-classes", "80", "--max-gt",
            str(TRAIN_MAX_GT), "--epochs", "1", "--steps-per-epoch",
            str(steps), "--eval-every", "0", "--device", "cuda", *extra]


def check_roi_align_grad():
    """The backward kernel against its plain version on the rois of one
    full-size training step of the mask preset (taken through the loss's
    stage hook) with a seeded cotangent, twice (the two runs must be
    bitwise equal); its time, bound and the plain version's time; and the
    forward kernel at the training shapes in fp32."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_backward_reference,
        roi_align_reference,
        roi_footprint,
        roi_geometry,
    )
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss
    from mrla_tpu_torch.kernels.roialign_patch import (
        roi_align_grad_kernel,
        roi_align_kernel,
    )

    args = train_cli.parse_args(train_argv(MASK_PRESET, 1))
    model = train_cli.build_model(args, torch.device("cuda"))
    batch = train_cli.to_device(next(train_cli.data_iter(args, True, 0)),
                                "cuda")
    seen = {}

    def keep(name, fn, *a, **kw):
        if "RoIAlign" in name:
            seen[name] = a
        return fn(*a, **kw)

    with torch.no_grad():
        faster_rcnn_train_loss(
            model, batch["image"], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_valid"], torch.Generator("cuda").manual_seed(5),
            gt_masks=batch["gt_masks"], stage=keep)
    feats = [f.float().contiguous() for f in seen["RoIAlign 7x7"][0][:4]]
    hw = [tuple(f.shape[1:3]) for f in feats]
    gen = torch.Generator("cuda").manual_seed(6)
    rows, cases = {}, {}
    for name, o in (("RoIAlign 7x7", 7), ("mask RoIAlign 14x14", 14)):
        rois, valid = seen[name][1], seen[name][2]
        b, p, c = rois.shape[0], rois.shape[1], feats[0].shape[-1]
        geom, smax = roi_geometry(rois, valid, hw, ROI_STRIDES, o, 0)
        cases[name] = (feats, o, smax, geom)
        ct = torch.randn(b, p, o, o, c, generator=gen, device="cuda")
        got = roi_align_grad_kernel(ct, geom, hw, smax)
        again = roi_align_grad_kernel(ct, geom, hw, smax)
        want = roi_align_backward_reference(ct, geom, hw, o, smax)
        mags = roi_align_backward_reference(ct.abs(), geom, hw, o, smax)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        worst = max(((g - w).abs() / (GRAD_ROUNDINGS * 2.0 ** -24 * m
                                      + 1e-30)).max().item()
                    for g, w, m in zip(got, want, mags))
        boxes_same = torch.equal(kernel_boxes(ct, geom, hw, smax),
                                 roi_footprint(geom, hw, o, smax))
        ms = cuda_ms(lambda: roi_align_grad_kernel(ct, geom, hw, smax))
        plain_ms = cuda_ms(lambda: roi_align_backward_reference(
            ct, geom, hw, o, smax), iters=3, warmup=1)
        nbytes, ops = grad_work(hw, b, c, geom, o, smax)
        bound_ms, by = bound(nbytes, 0, ops)
        g = geom.reshape(-1, geom.shape[-1])
        live = g[:, 6] > 0
        levels = torch.bincount(g[live, 7].long(), minlength=4).tolist()
        rows[("bwd", b, p, o, c)] = dict(
            shape=f"{TRAIN_PATH} {name}: [{b},{p}] rois, out {o}x{o}, C {c}",
            max_abs_err=err, reruns_bitwise_equal=same, tol_ratio=worst,
            boxes_are_roi_footprint=boxes_same,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=None)
        print(f"roi_align_bwd {name} [{b},{p},{o},{o},{c}] fp32: valid rois "
              f"{int(live.sum())}, by level {levels}; max|Δgrad| {err:.3g} "
              f"(worst cell at {worst:.3g} of its limit, {GRAD_ROUNDINGS} "
              f"fp32 roundings of the sum of its terms' magnitudes); two "
              f"runs {'bitwise equal' if same else 'DIFFER'} at max|grad| "
              f"{max(w.abs().max().item() for w in want):.4g}; its rois' "
              f"boxes {'are' if boxes_same else 'DIFFER FROM'} "
              f"roi_footprint's bit for bit | kernel {ms:.4f} ms (its "
              f"per-roi pass inside), bound "
              f"{bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} GFLOP), plain {plain_ms:.4f} ms, library "
              f"n/a (no PyTorch call computes it)")
        if not worst <= 1.0:
            raise AssertionError(f"roi_align_bwd {name}: a cell beyond its "
                                 f"limit ({worst:.3g})")
        if not same:
            raise AssertionError(f"roi_align_bwd {name}: two runs differ")
        if not boxes_same:
            raise AssertionError(f"roi_align_bwd {name}: its boxes are not "
                                 f"roi_footprint's")
        del got, again, want, mags, ct
    cases["gt mask crop"] = crop_case(seen["mask RoIAlign 14x14"], batch)
    for name, case in cases.items():
        time_forward(name, *case)
    return rows


def kernel_boxes(ct, geom, hw, smax) -> torch.Tensor:
    """The rois' boxes as the backward kernel computes them: its C entry
    point over uncleared buffers, the start of its scratch read back."""
    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.roialign_patch import (
        grad_scratch,
        launch_grad,
        scratch_boxes,
    )

    b, p, _, _, c = ct.shape
    bufs = [torch.empty(b, h, w, c, device="cuda") for h, w in hw]
    scratch = grad_scratch(ct, hw, fill=0xFF)
    check(launch_grad(bufs, geom, ct, scratch, smax), "roi_align_bwd")
    torch.cuda.synchronize()
    return scratch_boxes(scratch, b * p)


def crop_case(mask_inputs, batch):
    """The gt mask crop's operands: the masks as channels (fp32 canvas, the
    gt axis padded to a multiple of 8) and the geometry of the mask rois."""
    from mrla_tpu_torch.detect.roi_align import roi_geometry

    m4 = batch["gt_masks"].permute(0, 2, 3, 1).float().contiguous()
    geom, smax = roi_geometry(mask_inputs[1], None, [m4.shape[1:3]], (1,),
                              28, 1, 1e9)
    return [m4], 28, smax, geom


def time_forward(name, feats, o, smax, geom):
    """The forward kernel at a training shape (fp32): its error against the
    plain version, time, bound and plain time."""
    from mrla_tpu_torch.detect.roi_align import roi_align_reference
    from mrla_tpu_torch.kernels.roialign_patch import roi_align_kernel

    got = roi_align_kernel(feats, geom, o, smax)
    want = roi_align_reference(feats, geom, o, smax)
    err = (got - want).abs().max().item()
    tol = ROI_FP32_TERMS * 2.0 ** -24 * max(f.abs().max().item()
                                            for f in feats)
    ms = cuda_ms(lambda: roi_align_kernel(feats, geom, o, smax))
    plain_ms = cuda_ms(lambda: roi_align_reference(feats, geom, o, smax),
                       iters=3, warmup=1)
    nbytes, ops = roi_work(feats, geom, o, smax, 4)
    bound_ms, by = bound(nbytes, 0, ops)
    print(f"roi_align fwd, training {name} {list(got.shape)} fp32: "
          f"max|Δ| {err:.3g} (tol {tol:.3g}) | kernel {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms")
    if not err <= tol:
        raise AssertionError(f"roi_align fwd {list(got.shape)}: {err} > "
                             f"{tol}")


def check_roi_align_autograd():
    """torch.autograd.grad of a seeded function of roi_align_patch on CUDA
    tensors against the same on CPU copies (the wrapper's autograd on the
    card: on a wrapper whose CUDA output has no gradient this fails), and
    the valid-ignored fault of the backward, which must fail it."""
    import mrla_tpu_torch.kernels.roialign_patch as rp

    gen = torch.Generator("cuda").manual_seed(7)
    hw = ((100, 168), (50, 84), (25, 42), (13, 21))
    b, p, c = 2, 200, 256
    feats = [torch.randn(b, h, w, c, generator=gen, device="cuda")
             for h, w in hw]
    u = lambda *s: torch.rand(*s, generator=gen, device="cuda")
    scale = torch.exp(u(b, p) * 4.0 + 2.0)
    ar = torch.exp((u(b, p) - 0.5) * 2.2)
    cx, cy = u(b, p) * 672, u(b, p) * 400
    w, h = scale * ar.sqrt(), scale / ar.sqrt()
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    valid = u(b, p) > 0.2
    ct = torch.randn(b, p, 7, 7, c, generator=gen, device="cuda")

    def grads(fs, r, v, wt):
        fs = [f.detach().requires_grad_() for f in fs]
        out = rp.roi_align_patch(fs, r, v, (4, 8, 16, 32), 7, 0)
        return torch.autograd.grad((out * wt).sum(), fs)

    want = grads([f.cpu() for f in feats], rois.cpu(), valid.cpu(), ct.cpu())

    def err(got):
        return max(((g.cpu() - w).norm() / w.norm()).item()
                   for g, w in zip(got, want))

    rp.roi_align_patch.counter.reset()
    sound = err(grads(feats, rois, valid, ct))
    launched = dict(rp.roi_align_patch.counter.by_shape)
    real = rp.roi_align_grad_kernel

    def valid_ignored(g, geom, *a):
        geom = geom.clone()
        geom[..., 6] = 1.0
        return real(g, geom, *a)

    rp.roi_align_grad_kernel = valid_ignored
    try:
        fault = err(grads(feats, rois, valid, ct))
    finally:
        rp.roi_align_grad_kernel = real
    tol = AUTOGRAD_TOL
    print(f"roi_align_patch autograd on the card against the CPU (2 x 200 "
          f"rois, 7x7, C 256, seeded cotangent): gradient error {sound:.3g} "
          f"(tol {tol}), launches {launched}; with valid ignored in the "
          f"backward {fault:.3g}")
    if not (sound <= tol and launched.get(("bwd", b, p, 7, c)) == 1):
        raise AssertionError("roi_align_patch autograd on the card")
    if not fault > tol:
        raise AssertionError("the autograd check misses the valid fault")


def insitu_errors(model, batch, rand, ref, targets):
    """One training step of the card's model against the CPU's (``ref``:
    its loss terms and gradients to P2..P5) on the CPU's sampled rois."""
    from mrla_tpu_torch.testing import rcnn_pyramid_grads

    losses, _, grads = rcnn_pyramid_grads(model, batch, rand, targets)
    loss = max(abs(losses[k].item() - ref[0][k].item()) / abs(ref[0][k].item())
               for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                         "loss_bbox"))
    # per level relative to its norm; a level no roi reaches (zero on the
    # CPU) relative to the norm of the whole gradient
    whole = torch.cat([w.flatten() for w in ref[2]]).norm()
    grad = max(((g.cpu() - w).norm() / (w.norm() if w.norm() > 0 else whole))
               .item() for g, w in zip(grads, ref[2]))
    return {"loss": loss, "grad": grad}


def check_insitu():
    """One full-depth training step on the card against the same step on
    the CPU (INSITU_PX square, INSITU_BATCH images, the same weights and
    uniforms, the CPU's sampled rois fed to both), and the three backward
    faults in situ."""
    import mrla_tpu_torch.kernels.roialign_patch as rp
    from mrla_tpu_torch.detect.roi_align import (
        map_roi_levels,
        roi_align_backward_reference,
    )
    from mrla_tpu_torch.testing import (
        detection_batch,
        rcnn_pyramid_grads,
        train_uniforms,
        training_detector,
    )

    t0 = time.perf_counter()
    model = training_detector(0, num_classes=80, px=(256, 256))
    batch = detection_batch(2, INSITU_BATCH, INSITU_PX, 80, TRAIN_MAX_GT,
                            False)
    side = [-(-INSITU_PX // 4)]  # P2, then each level halves, rounding up
    for _ in range(4):
        side.append(-(-side[-1] // 2))
    n_anchors = 3 * sum(h * h for h in side)
    rand = train_uniforms(3, INSITU_BATCH, n_anchors,
                          TRAIN_MAX_GT + model.num_proposals)
    ref = rcnn_pyramid_grads(model, batch, rand)
    targets = ref[1]
    levels = torch.bincount(map_roi_levels(
        targets["rois"][targets["roi_valid"]], 4), minlength=4).tolist()
    print(f"in-situ step: full depth {INSITU_PX}x{INSITU_PX} bs"
          f"{INSITU_BATCH}, CPU step in {time.perf_counter() - t0:.1f} s; "
          f"{int(targets['roi_valid'].sum())} sampled rois by level "
          f"{levels}; gradient norms of P2..P5 "
          f"{[round(w.norm().item(), 6) for w in ref[2]]}")
    model = model.to("cuda")
    batch = {k: v.to("cuda") for k, v in batch.items()}
    own = rcnn_pyramid_grads(model, batch, rand)[1]
    same = all(torch.equal(own[k].cpu(), targets[k]) for k in
               ("roi_valid", "labels", "gt_index"))
    print(f"in-situ step: the card's own sampled rois "
          f"{'equal' if same else 'differ from'} the CPU's; the CPU's are "
          f"fed to both")
    errs = insitu_errors(model, batch, rand, ref, targets)
    print("in-situ step against the CPU: " + ", ".join(
        f"{k} {v:.4g} (tol {INSITU_TOLS[k]})" for k, v in errs.items()))
    if any(not v <= INSITU_TOLS[k] for k, v in errs.items()):
        raise AssertionError(f"in-situ step beyond tolerance: {errs}")
    real = rp.roi_align_grad_kernel
    rp.roi_align_grad_kernel = lambda g, geom, hw, smax: \
        roi_align_backward_reference(g, geom, hw, g.shape[2], smax)
    try:
        plain = insitu_errors(model, batch, rand, ref, targets)
    finally:
        rp.roi_align_grad_kernel = real
    print(f"in-situ step with the plain backward on the card in place of the "
          f"kernel: gradient error {plain['grad']:.4g}")

    def faulty(kind):
        def grad_kernel(g, geom, hw, smax):
            geom = geom.clone()
            if kind == "xy":
                geom[..., [0, 1, 2, 3, 4, 5]] = geom[..., [1, 0, 3, 2, 5, 4]]
            elif kind == "level":
                geom[..., 7] = (geom[..., 7] + 1).clamp(max=len(hw) - 1)
            out = real(g, geom, hw, smax)
            return [o.zero_() for o in out] if kind == "dropped" else out
        return grad_kernel

    for kind in GRAD_FAULTS:
        rp.roi_align_grad_kernel = faulty(kind)
        try:
            fe = insitu_errors(model, batch, rand, ref, targets)
        finally:
            rp.roi_align_grad_kernel = real
        print(f"in-situ step with the backward fault {kind}: gradient error "
              f"{fe['grad']:.4g}")
        if not fe["grad"] > INSITU_TOLS["grad"]:
            raise AssertionError(f"the in-situ check misses the fault {kind}")


def train_path(preset: str, smi: str, extra=()):
    """train_cli.main at full width: TRAIN_WARMUP + TRAIN_TIMED steps with
    the counts set to 0 just before and read just after; ms / step and
    img/s over the timed steps, the peak memory, the launches by shape."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.kernels import roi_align_patch

    steps = TRAIN_WARMUP + TRAIN_TIMED
    counters = all_counters()
    with tempfile.TemporaryDirectory() as out:
        argv = train_argv(preset, steps, extra) + ["--output-dir", out]
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        launches, per_step = split_roi_counts(roi_align_patch.counter, steps)
        for k, c in counters.items():
            if k != "roi_align":
                launches[k], per_step[k] = c.launches, {
                    s: n / steps for s, n in c.by_shape.items()}
        line = json.loads(open(os.path.join(out, "log.jsonl")).readline())
    step_ms = sum(res["step_s"][TRAIN_WARMUP:]) / TRAIN_TIMED * 1e3
    data_ms = sum(res["data_s"][TRAIN_WARMUP:]) / TRAIN_TIMED * 1e3
    losses = {k: v for k, v in line.items() if k.startswith("loss")}
    desc = (f"{preset}{' ' + ' '.join(extra) if extra else ''}, "
            f"{TRAIN_PX}x{TRAIN_PX} bs{TRAIN_BATCH}")
    print(f"training {desc}: {step_ms:.2f} ms/step, "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} img/s over {TRAIN_TIMED} steps "
          f"after {TRAIN_WARMUP} (data {data_ms:.1f} ms/step beside it), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB, on {smi}; last losses {losses}; RoIAlign launches per step "
          f"{per_step['roi_align']} forward, {per_step['roi_align_bwd']} "
          f"backward")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{desc}: non-finite losses {losses}")
    want = dict(TRAIN_ROI)
    if preset == MASK_PRESET:
        want.update(TRAIN_MASK_ROI)
    want_fwd = {s: 1.0 for s in want}
    want_bwd = {("bwd", *s): 1.0 for s in want if s[2] != 28}
    if (per_step["roi_align"] != want_fwd
            or per_step["roi_align_bwd"] != want_bwd
            or any(per_step[k] for k in counters if k != "roi_align")):
        raise AssertionError(f"{desc}: launches per step {per_step}, want "
                             f"{want_fwd} and {want_bwd}")
    del res
    return launches, per_step


def check_learning(smi: str):
    """A small detector learns the synthetic squares task on the card."""
    from mrla_tpu_torch.detect import train_cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        res = train_cli.main(LEARN_ARGV + ["--device", "cuda",
                                           "--output-dir", out])
        lines = [json.loads(s) for s in open(os.path.join(out, "log.jsonl"))]
    loss = res["loss"]
    first = sum(loss[:LEARN_WINDOW]) / LEARN_WINDOW
    last = sum(loss[-LEARN_WINDOW:]) / LEARN_WINDOW
    print(f"learning: faster_rcnn layers 1-1-1-1, 128 px, 3 classes, bs8, "
          f"lr 5e-3, {len(loss)} steps in {time.perf_counter() - t0:.1f} s "
          f"on {smi}: mean loss of the first {LEARN_WINDOW} steps "
          f"{first:.4f}, of the last {last:.4f} (ratio {last / first:.4f}, "
          f"tol {LEARN_RATIO_TOL}); AP50 {lines[-1]['AP50']:.4f}, mAP "
          f"{lines[-1]['mAP']:.4f}")
    if not last / first <= LEARN_RATIO_TOL:
        raise AssertionError(f"the loss fell only to {last / first:.3f} of "
                             f"its start")


def train_detect(smi: str):
    """The detection training phase; returns (RoIAlign backward rows,
    launches, launches per step by shape) of the main training path."""
    torch.cuda.empty_cache()
    rows = check_roi_align_grad()
    check_roi_align_autograd()
    check_insitu()
    torch.cuda.empty_cache()
    launches, per_step = train_path(DET_PRESET, smi)
    train_path(MASK_PRESET, smi)
    train_path(DET_PRESET, smi, ("--bf16",))
    check_learning(smi)
    return rows, launches, per_step


def kernels_line(rows, launches, per_forward):
    """One entry per kernel; ms, plain_ms and bound_ms are per forward: each
    shape's time weighted by its launches per forward on the kernel's main
    path (the DeiT path for the token tail, use_stage4=True for the stage
    kernel, use_stage4=False for the epilogue and mega-tail, the detection
    paths for RoIAlign, the tail routes for the block tails, row tail and
    copy); the launches counted on the other paths are listed beside."""
    meta = {
        "epilogue": ("mrla_light_epilogue", "mrla_tpu_torch/csrc/mrla_epilogue.cu",
                     "mrla_tpu/kernels/mrla_epilogue.py:128",
                     RESNET_PATHS[False]),
        "megatail": ("mrla_block_tail_fused_next",
                     "mrla_tpu_torch/csrc/mrla_megatail.cu",
                     "mrla_tpu/kernels/mrla_megatail.py:289",
                     RESNET_PATHS[False]),
        "stage4": ("stage4_resident", "mrla_tpu_torch/csrc/mrla_stage4.cu",
                   "mrla_tpu/kernels/mrla_stage4.py:312", RESNET_PATHS[True]),
        "deit_tail": ("deit_token_tail",
                      "mrla_tpu_torch/csrc/deit_token_tail.cu",
                      "mrla_tpu/kernels/deit_token_tail.py:227", DEIT_PATH),
        "roi_align": ("roi_align_patch", "mrla_tpu_torch/csrc/roi_align.cu",
                      "mrla_tpu/kernels/roialign_patch.py:306", DET_PATH),
        "roi_align_bwd": ("roi_align_bwd", "mrla_tpu_torch/csrc/roi_align.cu",
                          "mrla_tpu/kernels/roialign_patch.py:438",
                          TRAIN_PATH),
        "block_tail": ("mrla_block_tail",
                       "mrla_tpu_torch/csrc/mrla_block_tail.cu",
                       "mrla_tpu/kernels/mrla_epilogue.py:214",
                       TAIL_PATHS["block_tail"]),
        "rowtail": ("mrla_rowtail", "mrla_tpu_torch/csrc/mrla_rowtail.cu",
                    "mrla_tpu/kernels/mrla_rowtail.py:173",
                    TAIL_PATHS["rowtail"]),
        "block_tail_hwbc": ("mrla_block_tail_hwbc",
                            "mrla_tpu_torch/csrc/mrla_block_tail.cu",
                            "mrla_tpu/kernels/mrla_epilogue_hwbc.py:222",
                            TAIL_PATHS["block_tail"]),
        "copy": ("hwbc_copy", "mrla_tpu_torch/csrc/hwbc_copy.cu",
                 "scripts/exp_boundary.py:45", TAIL_PATHS["copy"]),
    }
    out = []
    for key, (name, source, replaces, path) in meta.items():
        counts = per_forward[path][key]
        shapes = [dict(rows[key][s], per_forward=n) for s, n in counts.items()]
        weighted = lambda f: sum(r[f] * r["per_forward"] for r in shapes)
        # what bounds the shape that holds most of the forward's bound
        by = max(shapes, key=lambda r: r["bound_ms"] * r["per_forward"])
        lib = [r.get("library_ms") for r in shapes]
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[path][key],
            "launches_per_forward": sum(counts.values()),
            "main_path": path,
            "launches_on_other_paths": {
                other: n.get(key, 0) for other, n in launches.items()
                if other != path},
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": weighted("ms"),
            "plain_ms": weighted("plain_ms"),
            "bound_ms": weighted("bound_ms"),
            "bound_by": by["bound_by"],
            # a PyTorch call computing the same function, where there is one
            "library_ms": (None if None in lib else weighted("library_ms")),
            "per_shape": shapes,
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from mrla_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {name}, count {count}, nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.build()}")
    for line in _build.ptxas_log().splitlines():
        if any(s in line for s in ("==", "Compiling entry", "registers",
                                   "spill")):
            print("  " + line.strip())

    rows = check_kernels(lib)
    launches, per_forward = serve(smi)
    launches[DEIT_PATH], per_forward[DEIT_PATH] = serve_deit(smi)
    rows["roi_align"], det_launches, det_per_forward = serve_detect(smi)
    launches.update(det_launches)
    per_forward.update(det_per_forward)
    rows["roi_align_bwd"], launches[TRAIN_PATH], per_forward[TRAIN_PATH] = \
        train_detect(smi)
    print(json.dumps(kernels_line(rows, launches, per_forward)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
