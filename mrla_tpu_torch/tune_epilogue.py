"""Time designs of the MRLA-light epilogue (``csrc/mrla_epilogue.cu``)
side by side on the card, at the shapes the serving paths give it.

    python -m mrla_tpu_torch.tune_epilogue

The variants (``tune_epilogue.cu``) are the sliding 3x3 window of
``csrc/tail_window.cuh`` over the epilogue's columns (out of three rows,
the centre row's identity) holding the window as fp32 or as packed bf16,
at 64 and 128 threads a block and rings of 2 to 8 columns, each walking
whole rows and shorter segments; and the per-vector kernel the window
replaced (a thread per 8 channels of one pixel).  At each shape it prints
one JSON line: the library's launch (``mrla_epilogue_describe``) and time,
and for each (variant, segment length) its time (CUDA events, 20 launches
after 3, warm L2), whether its y is bitwise the per-vector kernel's, its
blocks an SM and waves.  They are built with the library's nvcc flags into
``_build/tune/``; nothing of this module is on a serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
from pathlib import Path

import torch

from mrla_tpu_torch.kernels import _build

SOURCE = Path(__file__).with_suffix(".cu")
VARIANTS = {0: "fp32 window, 64 threads x 2 columns",
            1: "fp32 64 x 3", 2: "fp32 64 x 4", 3: "fp32 64 x 6",
            4: "fp32 64 x 8", 5: "fp32 128 x 4",
            6: "packed bf16 window, 64 x 2", 7: "packed 64 x 4",
            8: "packed 64 x 8", 9: "packed 128 x 4", 10: "packed 128 x 8",
            11: "vectors (a thread per pixel's 8 channels)"}
VECTORS = 11
# [B, H, W, C]: resnet50_mrlal at 224 px, batch 128 (layer3_5, layer4) and
# the detection trunk at 800 x 1344, batch 8
SHAPES = [(128, 14, 14, 1024), (128, 7, 7, 2048), (8, 50, 84, 1024),
          (8, 25, 42, 2048)]


def build() -> ctypes.CDLL:
    cdll = _build.build_tune(SOURCE)
    cdll.tune_epilogue.argtypes = [ctypes.c_int] * 2 + _build.SIGNATURES[
        "mrla_epilogue_bf16"]
    cdll.tune_epilogue.restype = ctypes.c_int
    cdll.tune_epilogue_describe.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cdll.tune_epilogue_describe.restype = ctypes.c_int
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


def segments(w: int) -> list:
    """Segment lengths tried on rows of w pixels: the whole row (up to 96)
    and cuts into 2 and 3."""
    return sorted({min(w, 96), -(-w // 2), -(-w // 3)}, reverse=True)


def run_shape(shape, tune, lib, gen) -> dict:
    b, h, w, c = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    out, idn = rnd(b, h, w, c).relu_().bfloat16(), rnd(b, h, w, c).bfloat16()
    vec = [torch.sigmoid(rnd(b, c)), rnd(9, c).mul_(0.3), rnd(c),
           rnd(c).mul_(0.2).add_(1.0), rnd(c).mul_(0.2)]
    ptrs = [out.data_ptr(), idn.data_ptr()] + [v.data_ptr() for v in vec]
    stream = torch.cuda.current_stream().cuda_stream
    want = torch.empty_like(out)
    _build.check(tune.tune_epilogue(VECTORS, 0, *ptrs, want.data_ptr(), b, h,
                                    w, c, stream), "vectors")
    y = torch.empty_like(out)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = (ctypes.c_int * 6)()
    _build.check(lib.mrla_epilogue_describe(b, h, w, c, ctypes.addressof(d)),
                 "mrla_epilogue_describe")
    lib_launch = lambda: lib.mrla_epilogue_bf16(*ptrs, y.data_ptr(), b, h, w,
                                                c, stream)
    y.fill_(float("nan"))
    _build.check(lib_launch(), "mrla_epilogue_bf16")
    torch.cuda.synchronize()
    row = {"shape": list(shape), "library": dict(
        ms=cuda_ms(lib_launch), bitwise=bool(torch.equal(y, want)),
        segment=d[0], threads=d[1], blocks_per_sm=d[2],
        waves=d[3] / (d[2] * sms), ring_columns=d[4], packed=d[5])}
    for v, name in VARIANTS.items():
        dv = (ctypes.c_int * 5)()
        _build.check(tune.tune_epilogue_describe(v, ctypes.addressof(dv)),
                     f"describe {name}")
        for seg in ([w] if v == VECTORS else segments(w)):
            launch = lambda: tune.tune_epilogue(v, seg, *ptrs, y.data_ptr(),
                                                b, h, w, c, stream)
            y.fill_(float("nan"))
            _build.check(launch(), f"{name} seg {seg}")
            torch.cuda.synchronize()
            items = b * h * (w if v == VECTORS else -(-w // seg)) * (c // 8)
            blocks = math.ceil(items / dv[1])
            row[f"{name}, segment {seg}"] = dict(
                ms=cuda_ms(launch), bitwise=bool(torch.equal(y, want)),
                blocks_per_sm=dv[0], waves=blocks / (dv[0] * sms),
                smem_bytes=dv[2])
    return row


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_epilogue: no CUDA device is available")
    lib, tune = _build.library(), build()
    print(f"device: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        row = run_shape(shape, tune, lib, gen)
        print(json.dumps(row), flush=True)
        if not all(r["bitwise"] for r in row.values() if isinstance(r, dict)):
            raise AssertionError(f"{shape}: a variant differs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
