"""Time the tiles of the tail + next-conv1 kernel (``csrc/tail_x1.cuh``)
side by side on the card, at the shapes the resnet50_mrlal paths give the
mega-tail and the row tail.

    python -m mrla_tpu_torch.tune_tail_x1

The variants (``tune_tail_x1.cu``) are the library's own tiles and the ones
they were chosen over: the same 64-pixel tiles with the product on
mma.sync + ldmatrix instead of wgmma, and tiles whose y phase walks 8-channel
vectors pixel after pixel instead of ``tail_x1_y_rows``.  At each shape it
prints, as one JSON line, the row tail's y alone (its C1 = 0 kernel), the
product alone as one PyTorch expression (a diagnostic), and for each variant
that takes the shape its time (CUDA events, 20 launches after 3, warm L2),
the time of its y phase alone (the same launch with C1 = 0), whether it
matches the plain version (y to 1 bf16 ulp, x1 to 2), its blocks an SM and
waves.  The variants are built with the library's nvcc flags into
``_build/tune/``; nothing of this module is on a serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
from pathlib import Path

import torch

from mrla_tpu_torch.kernels import _build
from mrla_tpu_torch.kernels.mrla_megatail import (
    mrla_block_tail_fused_next_reference,
)
from mrla_tpu_torch.kernels.mrla_rowtail import _fold, mrla_rowtail_reference

SOURCE = Path(__file__).with_suffix(".cu")
VARIANTS = {
    0: "64x64 wgmma, y rows",
    1: "64x128 wgmma, y rows x2 + weights",
    2: "48x128 mma.sync, y rows x2 + weights",
    3: "64x64 mma.sync, y rows",
    4: "64x128 mma.sync, y rows x2 + weights",
    5: "64x64 wgmma, y vectors",
    6: "64x128 wgmma, y vectors",
    7: "48x128 mma.sync, y vectors",
    8: "32x128 mma.sync, y vectors",
}
# (B, H, W, C, C1): 224 px batch 128, and the detection trunk's mega-tails
SHAPES = {
    "megatail": [(128, 56, 56, 256, 64), (128, 56, 56, 256, 128),
                 (128, 28, 28, 512, 128), (128, 28, 28, 512, 256),
                 (8, 200, 336, 256, 64), (8, 200, 336, 256, 128),
                 (8, 100, 168, 512, 128), (8, 100, 168, 512, 256),
                 (8, 50, 84, 1024, 256)],
    "rowtail": [(128, 56, 56, 256, 64), (128, 28, 28, 512, 256),
                (128, 14, 14, 1024, 256), (128, 14, 14, 1024, 512),
                (128, 7, 7, 2048, 512)],
}


def build() -> ctypes.CDLL:
    """Compile the variants (once per source digest) and load them."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        _build.NVCC_FLAGS).encode())
    for f in sorted(_build.CSRC.iterdir()):
        digest.update(f.read_bytes())
    out = _build.BUILD_ROOT / "tune" / digest.hexdigest()[:16]
    lib = out / "libtune_tail_x1.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _build.nvcc_path()
        procs = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, f"-DTUNE_ROWTAIL={k}", "-I",
             str(_build.CSRC), "-c", str(SOURCE), "-o", str(out / f"{k}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in (0, 1)]
        log = []
        for p in procs:
            text, _ = p.communicate()
            log.append(text)
            if p.returncode:
                raise RuntimeError(f"nvcc failed:\n{text}")
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                        str(out / "0.o"), str(out / "1.o")], check=True)
        (out / "ptxas.log").write_text("\n".join(log))
    cdll = ctypes.CDLL(str(lib))
    for kind in SHAPES:
        f = getattr(cdll, f"tune_x1_{kind}")
        f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        f = getattr(cdll, f"tune_x1_describe_{kind}")
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
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


def ulps(got, want, n) -> bool:
    want = want.float()
    return bool((got.float() - want).abs().max().item()
                <= n * 2.0 ** -7 * want.abs().max().item())


def run_shape(kind, shape, tune, lib, gen) -> dict:
    b, h, w, c, c1 = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    out = rnd(b, h, w, c).mul_(0.5).relu_().bfloat16()
    idn = rnd(b, h, w, c).bfloat16()
    gate, wv, lam = torch.sigmoid(rnd(b, c)), rnd(9, c).mul_(0.3), rnd(c)
    scale, bias = rnd(c).mul_(0.2).add_(1.0), rnd(c).mul_(0.2)
    w1 = (rnd(c1, c) / c ** 0.5).bfloat16()
    b1 = rnd(c1) * 0.2
    args = (out, idn, gate, wv, lam, scale, bias)
    gs, ls = _fold(gate, lam, scale)
    if kind == "megatail":
        y_ref, x1_ref = mrla_block_tail_fused_next_reference(*args, w1, b1)
        vec = [gate, wv, lam, scale, bias]
    else:
        y_ref, x1_ref = mrla_rowtail_reference(*args, w1, b1)
        vec = [gs, wv, ls, None, bias]
    ptrs = [out.data_ptr(), idn.data_ptr()] + [
        v.data_ptr() if v is not None else None for v in vec]
    y, x1 = torch.empty_like(out), torch.empty_like(x1_ref)
    tail = [w1.data_ptr(), b1.data_ptr(), y.data_ptr(), x1.data_ptr(),
            b, h, w, c, c1]
    stream = torch.cuda.current_stream().cuda_stream
    row = {"kernel": kind, "shape": list(shape)}
    row["y_only_ms"] = cuda_ms(lambda: lib.mrla_rowtail_bf16(
        ptrs[0], ptrs[1], gs.data_ptr(), wv.data_ptr(), ls.data_ptr(),
        bias.data_ptr(), None, None, y.data_ptr(), None, b, h, w, c, 0,
        stream))
    y2d, b1h = y_ref.reshape(-1, c), b1.bfloat16()
    row["product_ms"] = cuda_ms(lambda: torch.relu(y2d @ w1.t() + b1h))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fn = getattr(tune, f"tune_x1_{kind}")
    for v, name in VARIANTS.items():
        d = (ctypes.c_int * 6)()
        if getattr(tune, f"tune_x1_describe_{kind}")(
                v, c, ctypes.addressof(d)) or c1 % d[2]:
            continue
        y.zero_()
        x1.zero_()
        if fn(v, *ptrs, *tail, stream):
            raise RuntimeError(f"{name} at {shape}: launch failed")
        torch.cuda.synchronize()
        blocks = math.ceil(b * h * w / d[1])
        row[name] = dict(
            ms=cuda_ms(lambda: fn(v, *ptrs, *tail, stream)),
            # the same launch with C1 = 0: its y phase alone, no product
            y_phase_ms=cuda_ms(lambda: fn(v, *ptrs, *tail[:-1], 0, stream)),
            ok=ulps(y, y_ref, 1) and ulps(x1, x1_ref, 2),
            blocks_per_sm=d[0], waves=blocks / (d[0] * sms), smem_bytes=d[5])
    return row


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_tail_x1: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, tune = _build.library(), build()
    print(f"device: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, shapes in SHAPES.items():
        for shape in shapes:
            row = run_shape(kind, shape, tune, lib, gen)
            print(json.dumps(row), flush=True)
            if not all(r["ok"] for r in row.values() if isinstance(r, dict)):
                raise AssertionError(f"{kind} {shape}: a variant disagrees")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
