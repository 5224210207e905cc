"""Time the RoIAlign backward (``csrc/roi_align.cu``, ``roi_align_bwd``)
on the rois of one detection training step, and show where its blocks'
time goes.

    python -m mrla_tpu_torch.tune_roi_align_bwd [--wrapper-only]

The rois are those of one 800 x 800, batch 8 step of the mask preset
(taken through the loss's stage hook, as ``chip_smoke.py`` takes them):
512 a image at 7 x 7 (the box head) and 128 at 14 x 14 (the mask head),
with a seeded fp32 cotangent.  For each it prints a JSON line for the
wrapper ``roi_align_grad_kernel``, timed as ``chip_smoke.py`` times it
(CUDA events, 20 launches after 3), within its tolerance of the plain
version or not and bitwise equal run to run or not, with the boxes' plain
version ``roi_footprint`` alone timed beside it and the rois a tile meets;
then a line for each shape of the tile pass (``tune_roi_align_bwd.cu``:
the library's and the ones it was chosen over, built with each block's
clocks into ``_build/tune/``): the same checks (and its boxes
``roi_footprint``'s bit for bit or not), its time, each pass's device time
(``torch.profiler``, 5 launches), the slowest block's cycles, rois and
microseconds at the card's highest SM clock, and the mean block's cycles
in all and by phase (the roi scan, the table copies, the sums, the
store), with and without rois.  ``--wrapper-only`` times and checks the
wrapper alone (for a build of another design behind the same wrapper).
Nothing of this module is on a training path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from mrla_tpu_torch.kernels import _build

SOURCE = Path(__file__).with_suffix(".cu")
PRESET = "mask_rcnn_r50mrlal_fpn_1x_coco"
GRAD_ROUNDINGS = 64  # chip_smoke.py's tolerance: 64 fp32 roundings
TILE = 8  # cells a side of a tile (csrc/roi_align.cu kTH, kTW)


# the tile pass's shapes compared (tune_roi_align_bwd.cu): channels a
# block, 8-channel vectors a thread, chains of sums a thread; the first is
# the library's
SHAPES = {0: (128, 2, 2), 1: (256, 4, 1), 2: (128, 2, 1), 3: (64, 2, 2),
          4: (64, 1, 2)}


def build() -> ctypes.CDLL:
    """Compile the shapes with their block clocks (once per source digest)
    and load them."""
    cdll = _build.build_tune(SOURCE)
    cdll.tune_roi_bwd.argtypes = [ctypes.c_int] + _build.SIGNATURES[
        "roi_align_bwd"][:-1] + [ctypes.c_void_p, ctypes.c_void_p]
    cdll.tune_roi_bwd.restype = ctypes.c_int
    cdll.tune_roi_bwd_channels.argtypes = [ctypes.c_int]
    cdll.tune_roi_bwd_channels.restype = ctypes.c_int
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


def step_rois():
    """The pyramid sizes and the (rois, valid) of both RoIAligns of one
    training step of the mask preset at 800 x 800, batch 8."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss

    args = train_cli.parse_args([
        "--preset", PRESET, "--img-size", "800", "--batch-size", "8",
        "--num-classes", "80", "--max-gt", "32", "--epochs", "1",
        "--steps-per-epoch", "1", "--eval-every", "0", "--device", "cuda"])
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
    hw = [tuple(f.shape[1:3]) for f in seen["RoIAlign 7x7"][0][:4]]
    return hw, {name: (seen[name][1], seen[name][2], o) for name, o in (
        ("RoIAlign 7x7", 7), ("mask RoIAlign 14x14", 14))}


def tile_hits(boxes, geom, hw, b):
    """Rois meeting each tile, [B, tiles] in the kernel's tile order (top
    level first), from the boxes."""
    g = geom.reshape(-1, geom.shape[-1])
    p = geom.shape[1]
    img = torch.arange(b, device=g.device).repeat_interleave(p)
    live = g[:, 6] != 0
    per_level = []
    for lv in reversed(range(len(hw))):
        h, w = hw[lv]
        ty, tx = -(-h // TILE), -(-w // TILE)
        y0 = torch.arange(ty, device=g.device) * TILE
        x0 = torch.arange(tx, device=g.device) * TILE
        m = live & (g[:, 7].long() == lv)
        bx = boxes[m]
        meet = ((bx[:, 0, None, None] < y0[:, None] + TILE)
                & (bx[:, 1, None, None] > y0[:, None])
                & (bx[:, 2, None, None] < x0[None, :] + TILE)
                & (bx[:, 3, None, None] > x0[None, :]))  # [R, ty, tx]
        hits = torch.zeros(b, ty * tx, device=g.device)
        hits.index_add_(0, img[m], meet.flatten(1).float())
        per_level.append(hits)
    return torch.cat(per_level, 1)


def run_case(name, hw, rois, valid, o, tune) -> list:
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.detect.roi_align import (
        roi_align_backward_reference,
        roi_footprint,
        roi_geometry,
    )
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.kernels import roi_align_grad_kernel
    from mrla_tpu_torch.kernels.roialign_patch import (
        grad_scratch,
        scratch_boxes,
    )

    b, p, c = rois.shape[0], rois.shape[1], 256
    geom, smax = roi_geometry(rois, valid, hw, ROI_STRIDES, o, 0)
    gen = torch.Generator("cuda").manual_seed(6)
    ct = torch.randn(b, p, o, o, c, generator=gen, device="cuda")
    want = roi_align_backward_reference(ct, geom, hw, o, smax)
    tols = [GRAD_ROUNDINGS * 2.0 ** -24 * m + 1e-30
            for m in roi_align_backward_reference(ct.abs(), geom, hw, o, smax)]

    def judge(got, again):
        ratio = max(((g - w).abs() / t).max().item()
                    for g, w, t in zip(got, want, tols))
        return {"within_tol": ratio <= 1.0, "tol_ratio": ratio,
                "bitwise_reruns": all(torch.equal(g, a)
                                      for g, a in zip(got, again))}

    got = roi_align_grad_kernel(ct, geom, hw, smax)
    again = roi_align_grad_kernel(ct, geom, hw, smax)
    row = {"case": name, "shape": ["bwd", b, p, o, c], **judge(got, again),
           "wrapper_ms": cuda_ms(lambda: roi_align_grad_kernel(
               ct, geom, hw, smax))}
    rows = [row]
    if tune is None:
        return rows
    row["footprint_ms"] = cuda_ms(lambda: roi_footprint(geom, hw, o, smax))
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    dims = [x for h_w in hw for x in h_w] + [0, 0] * (4 - len(hw))
    tiles = sum(-(-h // TILE) * -(-w // TILE) for h, w in hw)
    for v, (cs, vecs, chains) in SHAPES.items():
        scratch = grad_scratch(ct, hw)
        clocks = torch.zeros(-(-c // tune.tune_roi_bwd_channels(v)), b,
                             tiles, 6, dtype=torch.int64, device="cuda")

        def launch(bufs):
            ptrs = [t.data_ptr() for t in bufs] + [None] * (4 - len(bufs))
            _build.check(tune.tune_roi_bwd(
                v, *ptrs, *dims, len(hw), geom.data_ptr(), ct.data_ptr(),
                scratch.data_ptr(), b, p, c, o, smax, clocks.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "tune_roi_bwd")

        outs = [[torch.empty(b, h, w, c, device="cuda") for h, w in hw]
                for _ in range(2)]
        launch(outs[0])
        launch(outs[1])
        torch.cuda.synchronize()
        row_v = {"tile_shape": {"channels": cs, "vectors": vecs,
                                "chains": chains},
                 **judge(*outs),
                 "boxes_are_roi_footprint": bool(torch.equal(
                     scratch_boxes(scratch, b * p),
                     roi_footprint(geom, hw, o, smax))),
                 "kernel_ms": cuda_ms(lambda: launch(outs[0]))}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                launch(outs[0])
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "roi_align_bwd" in e.key:
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = e.cuda_time_total
                part = "prep" if "prep" in e.key else "tiles"
                row_v[f"{part}_device_ms"] = total / e.count / 1e3
        flat = clocks.reshape(-1, 6).double()
        total = flat[:, 0]
        busy = flat[:, 5] > 0
        slowest = int(total.argmax())
        row_v.update(
            blocks=flat.shape[0], slowest_block_cycles=int(total.max()),
            slowest_block_us_at_max_clock=total.max().item() / mhz,
            slowest_block_rois=int(flat[slowest, 5]),
            mean_block_cycles=total.mean().item(),
            blocks_with_rois=int(busy.sum()),
            mean_cycles_with_rois=total[busy].mean().item(),
            mean_cycles_without=total[~busy].mean().item(),
            **{f"mean_{k}_cycles": flat[:, i].mean().item() for k, i in (
                ("scan", 1), ("build", 2), ("sums", 3), ("store", 4))})
        rows.append(row_v)
    boxes = roi_footprint(geom, hw, o, smax)
    hits = tile_hits(boxes, geom, hw, b)
    row.update(max_sm_clock_mhz=mhz, max_tile_rois=hits.max().item(),
               mean_tile_rois=hits.mean().item(),
               roi_tile_pairs=hits.sum().item())
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wrapper-only", action="store_true",
                    help="time and check the wrapper alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_roi_align_bwd: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tune = None if args.wrapper_only else build()
    print(f"device: {torch.cuda.get_device_name(0)}")
    hw, cases = step_rois()
    ok = True
    for name, (rois, valid, o) in cases.items():
        for row in run_case(name, hw, rois, valid, o, tune):
            print(json.dumps(row), flush=True)
            ok &= (row["within_tol"] and row["bitwise_reruns"]
                   and row.get("boxes_are_roi_footprint", True))
    if not ok:
        raise AssertionError("the backward disagrees with its plain version "
                             "or differs run to run, or its boxes differ")
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
