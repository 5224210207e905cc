"""Time designs of the RoIAlign forward (``csrc/roi_align.cu``,
``roi_align_fwd``) side by side on the card, on the rois of the detection
paths.

    python -m mrla_tpu_torch.tune_roi_align_fwd

The rois are those ``chip_smoke.py`` checks the kernel on: the serving
path's (a seeded Mask R-CNN at 800 x 1344, batch 8, bf16: 1000 proposals
an image at 7 x 7, 100 detections at 14 x 14) and those of one 800 x 800,
batch 8 training step of the mask preset (fp32: 512 sampled rois at 7 x 7,
the first 128 at 14 x 14 and the gt mask crop at 28 x 28 on the masks as
32 channels).  For each case it prints one JSON line: the rois by level,
mean gy * gx and the mean cells a bin weighs along y and x; for each
design (``tune_roi_align_fwd.cu``: the library's per-bin separable kernel
at its launch and at others, the row walk first tried for it at three
shapes, and the gather kernel it replaced) its time (CUDA events, 20
launches after 3, warm L2), its error against the plain version and that
error's limit (1 bf16 ulp at max|out| in bf16, 196 fp32 roundings of
max|feature| in fp32, as ``chip_smoke.py``), whether two launches are
bitwise equal and whether every element was written (the output
prefilled with NaN), with its groups of output rows, threads a block,
blocks a roi and shared memory.  They are built with the library's nvcc
flags into ``_build/tune/``; nothing of this module is on a serving or
training path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from mrla_tpu_torch.kernels import _build

SOURCE = Path(__file__).with_suffix(".cu")
# the designs of tune_roi_align_fwd.cu: the library's, the row walk at
# (output rows a thread, threads a block), the gather kernel it replaced,
# the library's kernel at other launches
VARIANTS = {0: "per-bin separable (the library's: 256 threads, 3 blocks "
               "an SM, row pairs)",
            1: "row walk 7 rows x 256 threads", 2: "row walk 4 x 256",
            3: "row walk 2 x 256", 4: "gather (a block per roi)",
            5: "per-bin 256 threads, row pairs",
            6: "per-bin 256 threads, rows by 4",
            7: "per-bin 256 threads, 2 blocks an SM, row pairs",
            8: "per-bin 256 threads, 2 blocks an SM, rows by 4",
            9: "per-bin 256 threads, 4 blocks an SM, row pairs",
            10: "per-bin 128 threads, 4 blocks an SM, rows by 4",
            11: "per-bin 256 threads, a row at a time"}
ROI_FP32_TERMS = 4 * 7 * 7  # chip_smoke.py's fp32 limit


def build() -> ctypes.CDLL:
    cdll = _build.build_tune(SOURCE)
    cdll.tune_roi_fwd.argtypes = [ctypes.c_int] + _build.SIGNATURES[
        "roi_align_fwd"]
    cdll.tune_roi_fwd.restype = ctypes.c_int
    cdll.tune_roi_fwd_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    cdll.tune_roi_fwd_plan.restype = ctypes.c_int
    return cdll


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def serving_cases() -> dict:
    """name -> (feats, geom, out, smax) of the serving path's two RoIAligns
    (bf16), as chip_smoke.py's check_roi_align takes them."""
    from mrla_tpu_torch.detect.roi_align import roi_geometry
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.serving import (
        prepare_detect_params,
        two_stage_detections,
    )
    from mrla_tpu_torch.testing import detector_serving_model, images

    model = detector_serving_model(0, "mask_rcnn_r50mrlal_fpn_1x_coco")
    params = prepare_detect_params(model, dtype=torch.bfloat16,
                                   device="cuda")
    seen = []

    def keep(name, fn, *args, **kw):
        if name.startswith("RoIAlign"):
            seen.append(args)
        return fn(*args, **kw)

    x = images(torch.Generator().manual_seed(4), 8, (800, 1344)).to("cuda")
    with torch.no_grad():
        two_stage_detections(params, x, "mask_rcnn_r50mrlal_fpn_1x_coco",
                             stage=keep)
    pyramid = [f.contiguous() for f in seen[0][0][:4]]
    hw = [f.shape[1:3] for f in pyramid]
    cases = {}
    for name, (_, rois, valid, o) in zip(("serving box head",
                                          "serving mask head"), seen):
        geom, smax = roi_geometry(rois, valid, hw, ROI_STRIDES, o, 0)
        cases[name] = (pyramid, geom, o, smax)
    return cases


def training_cases() -> dict:
    """name -> (feats, geom, out, smax) of the three RoIAligns of one mask
    preset training step (fp32), as chip_smoke.py's check_roi_align_grad
    takes them."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.detect.roi_align import roi_geometry
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss

    args = train_cli.parse_args([
        "--preset", "mask_rcnn_r50mrlal_fpn_1x_coco", "--img-size", "800",
        "--batch-size", "8", "--num-classes", "80", "--max-gt", "32",
        "--epochs", "1", "--steps-per-epoch", "1", "--eval-every", "0",
        "--device", "cuda"])
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
    hw = [f.shape[1:3] for f in feats]
    cases = {}
    for name, o in (("RoIAlign 7x7", 7), ("mask RoIAlign 14x14", 14)):
        geom, smax = roi_geometry(seen[name][1], seen[name][2], hw,
                                  ROI_STRIDES, o, 0)
        cases[f"training {name}"] = (feats, geom, o, smax)
    m4 = batch["gt_masks"].permute(0, 2, 3, 1).float().contiguous()
    geom, smax = roi_geometry(seen["mask RoIAlign 14x14"][1], None,
                              [m4.shape[1:3]], (1,), 28, 1, 1e9)
    cases["training gt mask crop"] = ([m4], geom, 28, smax)
    return cases


def run_case(name, feats, geom, o, smax, tune) -> dict:
    from mrla_tpu_torch.detect.roi_align import (
        axis_weights,
        roi_align_reference,
    )
    from mrla_tpu_torch.kernels.roialign_patch import (
        _DTYPE_FLAG,
        MAX_LEVELS,
        _level_dims,
    )

    b, c = feats[0].shape[0], feats[0].shape[-1]
    p = geom.shape[1]
    dtype = feats[0].dtype
    want = roi_align_reference([f.float() for f in feats], geom, o, smax)
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * want.abs().max().item()
    else:
        tol = ROI_FP32_TERMS * 2.0 ** -24 * max(f.abs().max().item()
                                                for f in feats)
    g = geom.reshape(-1, geom.shape[-1])
    live = g[:, 6] > 0
    hs = torch.tensor([f.shape[1] for f in feats], device=g.device)
    ws = torch.tensor([f.shape[2] for f in feats], device=g.device)
    lvl = g[live, 7].long()
    cells = [(axis_weights(g[live, k], g[live, 2 + k], g[live, 4 + k], n[lvl],
                           o, smax, int(n.max())) != 0).sum(-1).float()
             for k, n in ((0, hs), (1, ws))]
    row = {"case": name, "shape": [b, p, o, c], "dtype": str(dtype),
           "valid_rois": int(live.sum()),
           "by_level": torch.bincount(lvl, minlength=len(feats)).tolist(),
           "mean_gy_gx": (g[live, 4] * g[live, 5]).mean().item(),
           "mean_cells_a_bin_y_x": [c_.mean().item() for c_ in cells]}
    ptrs = [f.data_ptr() for f in feats] + [None] * (MAX_LEVELS - len(feats))
    dims = _level_dims([f.shape[1:3] for f in feats])
    stream = torch.cuda.current_stream().cuda_stream
    for v, label in VARIANTS.items():
        out = torch.full((b, p, o, o, c), float("nan"), dtype=dtype,
                         device="cuda")
        launch = lambda: tune.tune_roi_fwd(
            v, *ptrs, *dims, len(feats), geom.data_ptr(), out.data_ptr(), b,
            p, c, o, smax, _DTYPE_FLAG[dtype], stream)
        _build.check(launch(), label)
        torch.cuda.synchronize()
        written = not bool(out.isnan().any())
        first = out.clone()
        _build.check(launch(), label)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        plan = (ctypes.c_int * 4)()
        tune.tune_roi_fwd_plan(v, c, o, smax, ctypes.addressof(plan))
        row[label] = dict(ms=cuda_ms(launch), max_abs_err=err, tol=tol,
                          within_tol=err <= tol,
                          bitwise_reruns=bool(torch.equal(first, out)),
                          every_element_written=written, groups=plan[0],
                          threads=plan[1], blocks_a_roi=plan[2],
                          smem_bytes=plan[3])
    return row


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_roi_align_fwd: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tune = build()
    print(f"device: {torch.cuda.get_device_name(0)}")
    bad = []
    for cases in (serving_cases, training_cases):
        for name, case in cases().items():
            row = run_case(name, *case, tune)
            print(json.dumps(row), flush=True)
            bad += [f"{name}: {k}" for k, r in row.items()
                    if isinstance(r, dict) and not (
                        r["within_tol"] and r["bitwise_reruns"]
                        and r["every_element_written"])]
    if bad:
        raise AssertionError(f"designs off: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
