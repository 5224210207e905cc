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
     with ot doubled;
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
     peak device memory;
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
  8. one JSON line listing each ported kernel, its per-forward numbers
     weighted by the launches counted by shape on its main path;
  9. the nvidia-smi line, then the result line
     {"ok": true, "device": {"platform": "gpu", ...}}.

It needs one CUDA card and exits non-zero without printing a result when
there is none, or when the mrla_tpu_torch package is not beside it.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
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
        rows["megatail"][shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}] C1={c1}",
            max_abs_err=max(err_y, err_x1), tol=min(tol_y, tol_x1), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        print(f"megatail {stage} [{b},{h},{w},{c}] C1={c1} bf16: "
              f"max|Δy| {err_y:.3g} (tol {tol_y:.3g}: 1 bf16 ulp at max|y|), "
              f"max|Δx1| {err_x1:.3g} (tol {tol_x1:.3g}: 2 bf16 ulps at "
              f"max|x1|, its own rounding plus y's one-ulp flips) | kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{plain_ms:.4f} ms")
        if not (err_y <= tol_y and err_x1 <= tol_x1):
            raise AssertionError(f"megatail {stage}: y {err_y} > {tol_y} or "
                                 f"x1 {err_x1} > {tol_x1}")
        del a, y, x1, y_ref, x1_ref
    rows["stage4"] = check_stage4(gen)
    rows["deit_tail"] = check_deit_tail(lib, gen)
    torch.cuda.synchronize()
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
        fused_epilogue,
        mrla_block_tail_fused_next,
        roi_align_patch,
        stage4_resident,
    )

    return {"megatail": mrla_block_tail_fused_next.counter,
            "epilogue": fused_epilogue.counter,
            "stage4": stage4_resident.counter,
            "deit_tail": deit_token_tail.counter,
            "roi_align": roi_align_patch.counter}


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
    tables = {"megatail": MEGATAIL_SHAPES, "epilogue": EPILOGUE_SHAPES,
              "stage4": STAGE4_SHAPES, "deit_tail": {}, "roi_align": {}}
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
    return launches, per_forward


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


def roi_work(feats, geom, out_size: int, smax: int, out_bytes: int):
    """(bytes, fp32 operations) that one RoIAlign over ``geom`` needs on
    this data: the pyramid cells the rois' samples touch (the union of
    their footprints; with the adaptive grid every cell between a roi's
    first and last sample is touched) read once, the output written once,
    the geometry read once; 4 corners x (multiply, add) per live sample and
    channel."""
    from mrla_tpu_torch.detect.roi_align import axis_samples

    b, c = feats[0].shape[0], feats[0].shape[-1]
    g = geom.reshape(-1, geom.shape[-1])
    p = geom.shape[1]
    lvl = g[:, 7].long()
    img = torch.arange(b, device=g.device).repeat_interleave(p)
    hs = torch.tensor([f.shape[1] for f in feats], device=g.device)
    ws = torch.tensor([f.shape[2] for f in feats], device=g.device)
    ylo, yhi, wylo, wyhi = axis_samples(g[:, 0], g[:, 2], g[:, 4], hs[lvl],
                                        out_size, smax)
    xlo, xhi, wxlo, wxhi = axis_samples(g[:, 1], g[:, 3], g[:, 5], ws[lvl],
                                        out_size, smax)
    live_y, live_x = (wylo + wyhi) > 0, (wxlo + wxhi) > 0
    valid = g[:, 6] > 0
    n_y = live_y.flatten(1).sum(1).double()
    n_x = live_x.flatten(1).sum(1).double()
    ops = (valid * n_y * n_x).sum().item() * c * ROI_FP32_OPS
    keep = valid & (n_y > 0) & (n_x > 0)
    big = 1 << 30
    r0 = torch.where(live_y, ylo, big).flatten(1).amin(1)
    r1 = torch.where(live_y, yhi, -1).flatten(1).amax(1)
    c0 = torch.where(live_x, xlo, big).flatten(1).amin(1)
    c1 = torch.where(live_x, xhi, -1).flatten(1).amax(1)
    cells = 0
    for lv, f in enumerate(feats):
        m = keep & (lvl == lv)
        h, w = f.shape[1:3]
        diff = torch.zeros(b, h + 1, w + 1, device=g.device)
        for rr, cc, sign in ((r0, c0, 1.0), (r0, c1 + 1, -1.0),
                             (r1 + 1, c0, -1.0), (r1 + 1, c1 + 1, 1.0)):
            diff.index_put_((img[m], rr[m], cc[m]),
                            torch.full((int(m.sum()),), sign,
                                       device=g.device), accumulate=True)
        cells += int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0.5).sum())
    nbytes = (cells * c * feats[0].element_size()
              + g.shape[0] * out_size ** 2 * c * out_bytes + g.numel() * 4)
    return nbytes, ops


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


def kernels_line(rows, launches, per_forward):
    """One entry per kernel; ms, plain_ms and bound_ms are per forward: each
    shape's time weighted by its launches per forward on the kernel's main
    path (the DeiT path for the token tail, use_stage4=True for the stage
    kernel, use_stage4=False for the other two); the launches counted on
    the other paths are listed beside."""
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
                other: n[key] for other, n in launches.items()
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
    print(json.dumps(kernels_line(rows, launches, per_forward)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
