"""Time designs of the block tail from z (``csrc/mrla_block_tail.cu``)
side by side on the card, at the shapes the ``block_tail`` route gives it.

    python -m mrla_tpu_torch.tune_block_tail

The variants (``tune_block_tail.cu``) are the sliding 3x3 window with its
cp.async ring at 64, 128 and 256 threads a block and rings of 4 to 8
columns (the library's two first), each walking whole rows and halves;
the same window with the next column's loads in registers; and the
per-vector kernel the window replaced (a thread per 8 channels of one
pixel).  At each shape it prints one JSON line: for each (variant, segment
length) its time (CUDA events, 20 launches after 3, warm L2), whether it is
bitwise the library kernel's y, its blocks an SM and waves.  They are
built with the library's nvcc flags into ``_build/tune/``; nothing of this
module is on a serving path.
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
VARIANTS = {0: "ring 64 threads x 8 columns (the library's, W >= 28)",
            1: "ring 64 x 4 (the library's, W < 28)", 2: "ring 128 x 4",
            3: "ring 128 x 6",
            4: "ring 256 x 6", 5: "registers 256 threads, 1 column ahead",
            6: "vectors (a thread per pixel's 8 channels)"}
VECTORS = 6
# [B, H, W, C]: the block_tail route at 224 px, batch 128
SHAPES = [(128, 56, 56, 256), (128, 28, 28, 512), (128, 14, 14, 1024),
          (128, 7, 7, 2048)]


def build() -> ctypes.CDLL:
    """Compile the variants (once per source digest) and load them."""
    cdll = _build.build_tune(SOURCE)
    cdll.tune_block_tail.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    cdll.tune_block_tail.restype = ctypes.c_int
    cdll.tune_block_tail_describe.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cdll.tune_block_tail_describe.restype = ctypes.c_int
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


def run_shape(shape, tune, lib, gen) -> dict:
    b, h, w, c = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    z, idn = rnd(b, h, w, c).bfloat16(), rnd(b, h, w, c).bfloat16()
    vec = [torch.sigmoid(rnd(b, c)), rnd(9, c).mul_(0.3), rnd(c),
           rnd(c).mul_(0.2).add_(1.0), rnd(c).mul_(0.2)]
    ptrs = [z.data_ptr(), idn.data_ptr()] + [v.data_ptr() for v in vec]
    stream = torch.cuda.current_stream().cuda_stream
    want = torch.empty_like(z)
    _build.check(lib.mrla_block_tail_bf16(*ptrs, want.data_ptr(), b, h, w, c,
                                          stream), "mrla_block_tail_bf16")
    y = torch.empty_like(z)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"shape": list(shape)}
    for v, name in VARIANTS.items():
        d = (ctypes.c_int * 3)()
        _build.check(tune.tune_block_tail_describe(v, ctypes.addressof(d)),
                     f"describe {name}")
        for seg in ([w] if v == VECTORS else sorted({w, -(-w // 2)},
                                                     reverse=True)):
            launch = lambda: tune.tune_block_tail(v, seg, *ptrs, y.data_ptr(),
                                                  b, h, w, c, stream)
            y.fill_(float("nan"))
            _build.check(launch(), f"{name} seg {seg}")
            torch.cuda.synchronize()
            items = b * h * (w if v == VECTORS else -(-w // seg)) * (c // 8)
            blocks = math.ceil(items / d[1])
            row[f"{name}, segment {seg}"] = dict(
                ms=cuda_ms(launch), bitwise=bool(torch.equal(y, want)),
                blocks_per_sm=d[0], waves=blocks / (d[0] * sms),
                smem_bytes=d[2])
    return row


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_block_tail: no CUDA device is available")
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
