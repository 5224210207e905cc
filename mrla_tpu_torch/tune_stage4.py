"""Time the stage kernel (``csrc/mrla_stage4.cu``) launch by launch on the
card, beside the products through torch.matmul.

    python -m mrla_tpu_torch.tune_stage4 [--batch 128] [--trace CHECKOUT]

At ob [B,7,7,512] + xs [B,7,7,1024] -> [B,7,7,2048] (seeded operands,
``testing.stage4_case``) it prints JSON lines:

  * ``library``: each of the kernel's eight launches alone (products, the
    z products with their block tails; CUDA events, 20 launches after 3)
    with TFLOP/s, tiles, blocks and waves (``mrla_stage4_describe``), and
    the whole; y against the plain version (2 bf16 ulps), two launches
    bitwise equal and bitwise the library entry point's;
  * ``matmul``: the same eight products as bf16 ``torch.matmul`` on the
    same operands (the 3x3 on a prebuilt im2col matrix), a yardstick of
    what the products alone cost: the port never calls it;
  * ``trace`` (with ``--trace``, a checkout of another version of the
    port, e.g. ``git archive`` of an earlier commit unpacked): that
    checkout's kernel library is built there and one call of its
    ``mrla_stage4_bf16`` on the same operands is traced beside this
    library's (torch.profiler, 20 calls after 3): each kernel launch in
    order, its name and device ms, and each version's y against the plain
    version.  The entry point's arguments and scratch are this version's.

The steps are reached through ``tune_stage4.cu``, which includes the
library's source and is built with its nvcc flags into ``_build/tune/``;
nothing of this module is on a serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from mrla_tpu_torch.kernels import _build
from mrla_tpu_torch.kernels.mrla_stage4 import (
    entry_args,
    scratch,
    stage4_resident_reference,
)
from mrla_tpu_torch.testing import stage4_case

SOURCE = Path(__file__).with_suffix(".cu")
SHAPE = (1024, 512, 2048)  # CIN, C1, C
STEPS = ["id0", "z0 + tail 0", "x1 1", "o 1", "z1 + tail 1", "x1 2", "o 2",
         "z2 + tail 2"]


def build() -> ctypes.CDLL:
    """Compile the kernel's steps (once per source digest) and load them."""
    cdll = _build.build_tune(SOURCE)
    sig = _build.SIGNATURES["mrla_stage4_bf16"]
    cdll.tune_stage4_steps.argtypes = sig[:-1] + [ctypes.c_int] * 2 + sig[-1:]
    cdll.tune_stage4_steps.restype = ctypes.c_int
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


def product_flops(b: int) -> dict:
    """FLOPs of each step's product at batch b, by step name."""
    cin, c1, c = SHAPE
    m = b * 49
    f = {"id0": 2 * m * c * cin, "z": 2 * m * c * c1, "x1": 2 * m * c1 * c,
         "o": 2 * m * c1 * 9 * c1}
    key = lambda name: "z" if name.startswith("z") else name.split()[0]
    return {name: f[key(name)] for name in STEPS}


def ulps(y, ref) -> float:
    """max |y - ref| in bf16 ulps at the largest |ref|."""
    ref = ref.float()
    return ((y.float() - ref).abs().max() /
            (2.0 ** -7 * ref.abs().max())).item()


def matmul_row(ob, xs, packed, b: int) -> dict:
    """The eight products as bf16 torch.matmul on the same operands."""
    cin, c1, c = SHAPE
    m = b * 49
    gen = torch.Generator(device="cuda").manual_seed(1)
    xs2 = xs.reshape(m, cin).contiguous()
    ob2 = ob.reshape(m, c1)
    yb = torch.randn(m, c, generator=gen, device="cuda").bfloat16()
    x1 = torch.randn(b, c1, 7, 7, generator=gen, device="cuda").bfloat16()
    # im2col of x1, tap-major as k2's columns: [m, 9 * c1]
    cols = F.unfold(x1.float(), 3, padding=1).reshape(b, c1, 9, 49)
    cols = cols.permute(0, 3, 2, 1).reshape(m, 9 * c1).bfloat16()
    o = torch.randn(m, c1, generator=gen, device="cuda").bfloat16()
    prods = {"id0": (xs2, packed["kd"]), "z0": (ob2, packed["k3_0"]),
             "x1": (yb, packed["k1"][0]), "o": (cols, packed["k2"][0]),
             "z": (o, packed["k3"][0])}
    ms = {k: cuda_ms(lambda a=a, w=w: torch.matmul(a, w.t()))
          for k, (a, w) in prods.items()}
    total = ms["id0"] + ms["z0"] + 2 * (ms["x1"] + ms["o"] + ms["z"])
    flops = product_flops(b)
    return {"matmul_ms": ms, "eight_products_ms": total,
            "tflops": {k: flops[{"z0": "z0 + tail 0", "x1": "x1 1", "o": "o 1",
                                 "z": "z1 + tail 1"}.get(k, k)] / v / 1e9
                       for k, v in ms.items()}}


def trace_launches(fn, args_, stream, runs: int = 20) -> list:
    """[kernel name, device ms] of each launch of one call of ``fn`` (a
    ``mrla_stage4_bf16``), in order, the mean over ``runs`` traced calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        _build.check(fn(*args_, stream), "trace warm-up")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn(*args_, stream)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "memcpy" not in e.name.lower()
                      and "memset" not in e.name.lower()),
                     key=lambda e: e.time_range.start)
    per_call, rest = divmod(len(kernels), runs)
    if rest or not per_call:
        raise RuntimeError(f"{len(kernels)} kernels in {runs} traced calls")
    return [[kernels[i].name[:60],
             sum(kernels[r * per_call + i].time_range.elapsed_us()
                 for r in range(runs)) / runs / 1e3]
            for i in range(per_call)]


def checkout_library(checkout: Path) -> ctypes.CDLL:
    """The kernel library of another checkout of the port, built there by
    its own ``_build``, with ``mrla_stage4_bf16``'s argtypes set."""
    run = subprocess.run(
        [sys.executable, "-c", "from mrla_tpu_torch.kernels._build import "
         "build; print(build())"], cwd=checkout, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if run.returncode:
        raise RuntimeError(f"building {checkout} failed:\n{run.stdout}")
    cdll = ctypes.CDLL(run.stdout.strip().splitlines()[-1])
    cdll.mrla_stage4_bf16.argtypes = _build.SIGNATURES["mrla_stage4_bf16"]
    cdll.mrla_stage4_bf16.restype = ctypes.c_int
    return cdll


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--trace", type=Path, metavar="CHECKOUT",
                        help="trace this checkout's stage kernel beside "
                             "this one's, launch by launch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_stage4: no CUDA device is available")
    lib, tune = _build.library(), build()
    print(f"device: {torch.cuda.get_device_name(0)}")
    b = args.batch
    cin, c1, c = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    ob, xs, packed = stage4_case(gen, b, cin, c1, c)
    ref = stage4_resident_reference(ob, xs, packed)
    stream = torch.cuda.current_stream().cuda_stream
    flops = product_flops(b)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    y = torch.full((b, 7, 7, c), float("nan"), dtype=torch.bfloat16,
                   device="cuda")
    buffers = scratch(b, c1, c, "cuda")  # held while the launches run
    args_ = entry_args(ob, xs, packed, buffers, y)
    _build.check(lib.mrla_stage4_bf16(*args_, stream), "mrla_stage4_bf16")
    torch.cuda.synchronize()
    want = y.clone()
    run = lambda first, last: _build.check(
        tune.tune_stage4_steps(*args_, first, last, stream),
        f"steps {first}..{last}")
    y.fill_(float("nan"))
    run(0, len(STEPS))
    torch.cuda.synchronize()
    library = {"ulps_vs_plain": ulps(y, ref),
               "rerun_bitwise": bool(torch.equal(y, want)), "launches": {}}
    plan = (ctypes.c_int * 48)()
    _build.check(lib.mrla_stage4_describe(b, cin, c1, c,
                                          ctypes.addressof(plan)), "describe")
    for i, name in enumerate(STEPS):
        ms = cuda_ms(lambda i=i: run(i, i + 1))
        tiles, blocks, rows, cols, stages, smem = plan[6 * i:6 * i + 6]
        library["launches"][name] = dict(
            ms=ms, tflops=flops[name] / ms / 1e9, tiles=tiles, blocks=blocks,
            tile=f"{rows}x{cols}", ring_stages=stages, smem_bytes=smem,
            waves=tiles / (2 * sms))  # two consumer warpgroups a block
    library["total_ms"] = cuda_ms(lambda: run(0, len(STEPS)))
    print(json.dumps({"library": library}), flush=True)
    print(json.dumps({"matmul": matmul_row(ob, xs, packed, b)}), flush=True)
    if args.trace:
        trace = {}
        for name, fn in (("checkout", checkout_library(
                args.trace.resolve()).mrla_stage4_bf16),
                         ("library", lib.mrla_stage4_bf16)):
            y.fill_(float("nan"))
            launches = trace_launches(fn, args_, stream)
            trace[name] = {"ulps_vs_plain": ulps(y, ref),
                           "launches": launches,
                           "total_ms": sum(ms for _, ms in launches)}
        print(json.dumps({"trace": trace}), flush=True)
    if library["ulps_vs_plain"] > 2 or not library["rerun_bitwise"]:
        raise AssertionError("y off the plain version or reruns differ")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
